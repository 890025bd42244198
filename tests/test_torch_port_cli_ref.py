"""The eval CLI's JAX interface (``-m``, ``-c``, ``-d``, ``-ns``, ``-s``,
``-sba``, ``-ld``, ``-lm`` with a reference LM ``.pt``) and the serve CLI's
``-m``, against the JAX package's eval CLI on the CPU.

One tiny checkpoint is trained through the port's training CLI on the
corpus of ``tests/test_e2e.py`` and written for the JAX package too (an
orbax ``model.epoch.N`` with the run's config). Both CLIs decode the test
split: the decode directory's name and the 1-best ids of ``predict.txt``
must be JAX's, for ``-m`` as an expdir, a ``model.epoch.N`` and a reference
``.pt`` (the port's export), and the n-best of ``predict.log`` in JAX's
order with scores within 1e-3.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from opentransformer_tpu import compat as jax_compat
from opentransformer_tpu.cli.eval import main as jax_eval_main
from opentransformer_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.cli import serve
from opentransformer_tpu_torch.models.registry import build_model
from tests.test_e2e import make_config, make_corpus

EPOCHS = 60
BASE = ["-bw", "3", "-ml", "10", "-b", "8", "-d", "test"]
LM_CFG = {"type": "transformer_lm", "vocab_size": 11, "d_model": 16, "n_heads": 2, "d_ff": 32,
          "num_blocks": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(root, the port's expdir, the JAX expdir, epoch, config) of the
    trained checkpoint."""
    root = str(tmp_path_factory.mktemp("cliref"))
    make_corpus(root, n_utts=24)
    yaml_conf = make_config(root, epochs=EPOCHS, lr=0.006)
    with open(yaml_conf) as f:
        cfg = yaml.safe_load(f)
    conf = os.path.join(root, "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    port_exp = os.path.join(root, "port_exp")
    run_cli.run(["-c", conf, "--expdir", port_exp, "--device", "cpu", "--log_interval", "100"])
    epoch = EPOCHS - 1
    tree = compat.load_npz(os.path.join(port_exp, f"model.epoch.{epoch}", "params.npz"))
    jax_exp = os.path.join(root, "jax_exp")
    JaxCheckpointer(jax_exp, config=cfg).save_params_only(f"model.epoch.{epoch}", tree)
    return root, port_exp, jax_exp, epoch, cfg


def predictions(decode_dir):
    with open(os.path.join(decode_dir, "predict.txt")) as f:
        best = dict(line.rstrip("\n").split(" ", 1) for line in f)
    nbest = {}
    with open(os.path.join(decode_dir, "predict.log")) as f:
        for line in f:
            utt, _, score, *units = line.split()
            nbest.setdefault(utt, []).append((float(score.split("=")[1]), " ".join(units)))
    return best, nbest


def _fresh_decode(parent, decode):
    """Run ``decode()`` with no earlier decode directory under ``parent``;
    → (the new directory's name, its predictions)."""
    for name in os.listdir(parent):
        if name.startswith("decode_"):
            shutil.rmtree(os.path.join(parent, name))
    assert decode() == 0
    (name,) = [n for n in os.listdir(parent) if n.startswith("decode_")]
    return name, predictions(os.path.join(parent, name))


def _parent(model):
    base = os.path.basename(model.rstrip("/"))
    return os.path.dirname(model) if base.startswith("model.") else model


def jax_decode(model, *flags):
    return _fresh_decode(_parent(model), lambda: jax_eval_main(["-m", model, *BASE, *flags]))


def port_decode(model, *flags):
    return _fresh_decode(_parent(model), lambda: eval_cli.main(
        ["-m", model, *BASE, "--device", "cpu", *flags]))


def assert_same(got, want, labelled=True):
    (g_name, (g_best, g_nbest)), (w_name, (w_best, w_nbest)) = got, want
    assert g_name == w_name
    assert g_best == w_best and len(g_best) == 24
    if labelled:  # the trained model's 1-bests hold labels
        assert any(v.strip() for v in g_best.values())
    assert g_nbest.keys() == w_nbest.keys()
    for utt, hyps in w_nbest.items():
        assert [h for _, h in g_nbest[utt]] == [h for _, h in hyps], utt
        np.testing.assert_allclose([s for s, _ in g_nbest[utt]], [s for s, _ in hyps],
                                   rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def jax_base(run):
    _, _, jax_exp, _, _ = run
    return jax_decode(jax_exp)


@pytest.mark.parametrize("source", ["expdir", "model.epoch.N", ".pt"])
def test_m_source_decodes_as_jax(run, jax_base, tmp_path, source):
    root, port_exp, _, epoch, cfg = run
    if source == "expdir":
        model, flags = port_exp, []
    elif source == "model.epoch.N":
        model, flags = os.path.join(port_exp, f"model.epoch.{epoch}"), []
    else:
        # the port's export as a reference .pt, with the config as -c
        os.makedirs(str(tmp_path / "ref"))
        model = str(tmp_path / "ref" / f"model.epoch.{epoch}.pt")
        loaded = compat.load_into(build_model(cfg["model"], device="cpu"), compat.load_npz(
            os.path.join(port_exp, f"model.epoch.{epoch}", "params.npz")))
        torch.save(compat.export_reference_checkpoint(loaded, cfg), model)
        flags = ["-c", os.path.join(root, "conf.json")]
    assert_same(port_decode(model, *flags), jax_base)


def sort_by_avg_score(nbest):
    """The JAX CLI's -sba order: score / (words + 1), descending, stable."""
    return sorted(nbest, key=lambda sh: -sh[0] / max(len(sh[1].split()) + 1, 1))


def test_c_ns_s_sba_ld_decode_as_jax(run):
    """``-c -ns 8 -s sba -ld 2.0`` with ``-sba``. The JAX CLI's ``-sba``
    writes into a read-only array on this platform and raises
    (``opentransformer_tpu/cli/eval.py:301``), so JAX decodes without it and
    its n-best lists are ranked by JAX's -sba rule here."""
    root, port_exp, jax_exp, epoch, _ = run
    flags = ["-ns", "8", "-s", "sba", "-ld", "2.0"]
    w_name, (_, w_nbest) = jax_decode(os.path.join(jax_exp, f"model.epoch.{epoch}"), "-c",
                                      os.path.join(root, "conf_speech2text.yaml"), *flags)
    g_name, (g_best, g_nbest) = port_decode(os.path.join(port_exp, f"model.epoch.{epoch}"),
                                            "-c", os.path.join(root, "conf.json"), *flags,
                                            "-sba")
    assert g_name == w_name == "decode_test_bw3_pn0.6_ml10_sba"
    assert len(g_best) == len(w_nbest) == 8 and g_nbest.keys() == w_nbest.keys()
    for utt, hyps in w_nbest.items():
        want = sort_by_avg_score(hyps)
        assert [h for _, h in g_nbest[utt]] == [h for _, h in want], utt
        assert g_best[utt] == want[0][1]
        np.testing.assert_allclose([sc for sc, _ in g_nbest[utt]], [sc for sc, _ in want],
                                   rtol=0, atol=1e-3)


def test_reference_lm_pt_fuses_as_jax(run, tmp_path):
    """``-lm`` with a reference-layout LM ``.pt`` (the JAX package's export
    of a seeded LM) at weight 0.3, in both CLIs."""
    import jax
    import jax.numpy as jnp

    from opentransformer_tpu.models.registry import build_model as jax_build_model

    _, port_exp, jax_exp, epoch, _ = run
    jm = jax_build_model(LM_CFG)
    ones = jnp.ones((1, 4), jnp.int32)
    params = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(2), ones, ones,
                                                      jnp.asarray([4])))
    lm_pt = str(tmp_path / "lm.pt")
    torch.save(jax_compat.export_reference_checkpoint(params, {"model": LM_CFG}), lm_pt)
    flags = ["-lm", lm_pt, "-lmw", "0.3"]
    want = jax_decode(os.path.join(jax_exp, f"model.epoch.{epoch}"), *flags)
    got = port_decode(os.path.join(port_exp, f"model.epoch.{epoch}"), *flags)
    assert want[0] == "decode_test_bw3_pn0.6_ml10_lm0.3"
    assert_same(got, want, labelled=False)  # the random LM may favour early ends


def test_serve_m_equals_serve_npz(run, tmp_path):
    """The serve CLI loads ``-m EXP`` (config, features and vocabulary from
    the run) and answers as with ``--npz`` and ``--model_cfg``."""
    import scipy.io.wavfile as siw

    root, port_exp, _, epoch, cfg = run
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        path = str(tmp_path / f"w{i}.wav")
        siw.write(path, 16000, (rng.normal(size=8000) * 3000).astype(np.int16))
        lines.append(f"w{i} {path}")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    with open(os.path.join(port_exp, "config.json")) as f:
        run_cfg = json.load(f)
    run_cfg["data"]["num_mel_bins"] = 16
    with open(os.path.join(port_exp, "config.json"), "w") as f:
        json.dump(run_cfg, f)
    common = ["-i", str(tmp_path / "wav.scp"), "-bw", "3", "-ml", "10", "--device", "cpu"]
    out_m, out_npz = str(tmp_path / "m.txt"), str(tmp_path / "npz.txt")
    assert serve.main(["-m", port_exp, "-o", out_m, *common]) == 0
    assert serve.main(["--npz", os.path.join(port_exp, f"model.epoch.{epoch}", "params.npz"),
                       "--model_cfg", os.path.join(port_exp, "config.json"), "-o", out_npz,
                       *common]) == 0
    with open(out_m) as a, open(out_npz) as b:
        got, want = sorted(a.read().splitlines()), sorted(b.read().splitlines())
    assert len(got) == 3 and got == want


# ------------------------------------------------ the reference flags
def _sample_value(action):
    """A value for an option that differs from its default."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[-1])]
    if action.type is int:
        return ["3"]
    if action.type is float:
        return ["0.25"]
    return ["given"]


@pytest.mark.parametrize("cli", ["eval", "run"])
def test_every_jax_option_parses_to_the_same_value(cli):
    """Every option string of the JAX CLI's parser parses in the port's to
    the same destination and value (the port may have more)."""
    import argparse

    from opentransformer_tpu.cli import eval as jax_eval
    from opentransformer_tpu.cli import run as jax_run

    jax_parser = (jax_eval if cli == "eval" else jax_run).build_argparser()
    ours = (eval_cli if cli == "eval" else run_cli).build_argparser()
    required = ["-m", "m"] if cli == "eval" else ["-c", "c"]
    checked = 0
    for action in jax_parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for opt in action.option_strings:
            argv = ([] if opt in required else required) + [opt] + _sample_value(action)
            if cli == "eval" and opt in ("-c", "--config"):
                argv = ["-m", "m"] + argv
            want = vars(jax_parser.parse_args(argv))[action.dest]
            got = vars(ours.parse_args(argv))
            assert action.dest in got and got[action.dest] == want, (opt, got.get(action.dest))
            checked += 1
    assert checked > 30


def test_debug_and_ignored_flags_decode_ten_utterances_as_jax(run):
    """``-debug`` stops after the batch that reaches 10 utterances (at -b 2,
    exactly 10), with ``-pf -test -resc -rw 0.5`` accepted and ignored, in
    both CLIs; ``-debug`` is no longer ``-d ebug``."""
    _, port_exp, jax_exp, epoch, _ = run
    flags = ["-b", "2", "-debug", "-pf", "-test", "-resc", "-rw", "0.5"]
    args = eval_cli.build_argparser().parse_args(["-m", "x", "-debug"])
    assert args.debug and args.decode_set == "test"
    w_name, (w_best, w_nbest) = jax_decode(os.path.join(jax_exp, f"model.epoch.{epoch}"), *flags)
    g_name, (g_best, g_nbest) = port_decode(os.path.join(port_exp, f"model.epoch.{epoch}"),
                                            *flags)
    assert g_name == w_name and len(g_best) == len(w_best) == 10
    assert g_best == w_best and g_nbest.keys() == w_nbest.keys()
    for utt, hyps in w_nbest.items():
        assert [h for _, h in g_nbest[utt]] == [h for _, h in hyps], utt
