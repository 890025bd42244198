"""The port's measuring tools and configurations, on the CPU.

  * ``conf/flagship_bench.json`` equals ``__graft_entry__``'s model and
    train dicts, ``conf/flagship.json`` / ``flagship_cont.json`` equal
    ``yaml.safe_load`` of ``egs/synth_bench/conf/flagship*.yaml``, and the
    stream tool's frontend and encoder equal ``tools/stream_latency.py``'s;
  * each tool of ``tools/torch_*.py`` runs with ``--device cpu`` at a tiny
    size and prints its JSON line; the decode tool's surgery, conformer and
    LM variants build the parameter shapes JAX's same overrides build (the
    encoders cut to one block, the widths as the tool has them);
  * ``torch_probe_cost_analysis``: the 4-micro-batch update counts exactly
    4x one update and 20 updates 20x; on a tiny model one update's count is
    between 0.5 and 1.0 of XLA's ``cost_analysis()["flops"]`` for JAX's same
    update on the CPU. The counter counts the products only; XLA also counts
    the elementwise operations (the activations, norms, softmaxes, the loss
    and Adam), which at d32 are a large share, so the port's count is
    lower, and it is not far lower because the products still dominate;
  * ``torch_probe_decode_precision`` on the first 8 test utterances in f32:
    1-best ids off the JAX fixture on at most 1 of 8;
  * ``torch_stream_latency`` with 4 streams x 1 s: every stream has a FINAL
    in both modes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "opentransformer_tpu_torch", "conf")
# a d32 model for the update tools (the flagship's sections, cut in width)
TINY = {"model": {"type": "speech2text", "frontend_type": "conv",
                  "frontend": {"input_size": 40, "output_size": 32, "in_channel": 1,
                               "mid_channel": 4, "out_channel": 8,
                               "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2],
                               "dropout": 0.0, "act_func_type": "relu"},
                  "encoder_type": "transformer",
                  "encoder": {"d_model": 32, "n_heads": 2, "d_ff": 64, "n_blocks": 2,
                              "residual_dropout": 0.0, "normalize_before": False,
                              "activation": "glu", "relative_positional": False},
                  "decoder_type": "transformer",
                  "decoder": {"vocab_size": 50, "d_model": 32, "n_heads": 2, "d_ff": 64,
                              "memory_dim": 32, "n_blocks": 1, "residual_dropout": 0.0,
                              "activation": "glu", "share_embedding": True},
                  "ctc_weight": 0.0, "smoothing": 0.1},
        "train": {"optimizer_type": "adam",
                  "optimizer": {"lr": 1e-3, "betas": [0.9, 0.98], "eps": 1e-9,
                                "weight_decay": 1e-6},
                  "scheduler_type": "transformer",
                  "scheduler": {"model_size": 32, "warmup_steps": 12000, "factor": 1.0},
                  "clip_grad": 5, "accum_steps": 1, "epochs": 1}}
B, T, U = 2, 64, 4
XLA_BAND = (0.5, 1.0)


def tool(name: str):
    """``tools/<name>.py`` as a module."""
    import chip_smoke

    return chip_smoke.load_tool(name)


def run_tool(name: str, argv: list) -> tuple[dict | None, str]:
    """``main(argv)`` of a tool → (its last line as JSON, or None when it
    is not a JSON object, and all it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool(name).main(argv) == 0
    text = out.getvalue()
    last = text.strip().splitlines()[-1]
    return (json.loads(last) if last.startswith("{") else None), text


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tools' CPU runs on one thread, as the other port tests run;
    yields the threads torch had."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield threads
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_conf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tools") / "tiny.json")
    with open(path, "w") as f:
        json.dump(TINY, f)
    return path


# ------------------------------------------------------------ the configs
def test_flagship_bench_is_the_graft_entry_dicts():
    sys.path.insert(0, REPO)
    from __graft_entry__ import FLAGSHIP_MODEL_CFG, TRAIN_CFG

    with open(os.path.join(CONF, "flagship_bench.json")) as f:
        cfg = json.load(f)
    assert cfg == {"model": FLAGSHIP_MODEL_CFG, "train": TRAIN_CFG}


@pytest.mark.parametrize("name", ["flagship", "flagship_cont"])
def test_flagship_json_is_the_yaml(name):
    with open(os.path.join(REPO, "egs", "synth_bench", "conf", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(CONF, f"{name}.json")) as f:
        assert json.load(f) == want


def test_stream_tool_geometry_is_jax_tools():
    jax_tool, ours = tool("stream_latency"), tool("torch_stream_latency")
    assert ours.FRONTEND == jax_tool.FRONTEND and ours.ENCODER == jax_tool.ENCODER


# ------------------------------------------------- decode tool's variants
def jax_param_shapes(cfg: dict, text: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    from opentransformer_tpu.models.registry import build_model as jax_build_model

    model = jax_build_model(cfg)
    if text:
        args = (jnp.ones((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32),
                jnp.asarray([8, 8], jnp.int32))
    else:
        args = (jnp.zeros((2, 96, 40), jnp.float32), jnp.ones((2, 96), bool),
                jnp.ones((2, 8), jnp.int32), jnp.asarray([6, 6], jnp.int32))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    return flat_shapes(tree)


def flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def port_param_shapes(cfg: dict) -> dict:
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    return flat_shapes(compat.params_to_jax(build_model(cfg, device="cpu"))["params"])


def one_block_encoder(cfg: dict) -> dict:
    """``cfg`` with its encoder cut to one block: the surgery changes the
    decoder alone, and a block's shapes do not depend on the depth, so one
    block checks every width at a fraction of the build."""
    key = "nblocks" if cfg.get("encoder_type") == "conformer" else "n_blocks"
    return dict(cfg, encoder=dict(cfg["encoder"], **{key: 1}))


def variant_cfgs():
    pd = tool("torch_profile_decode")
    out = [(label, one_block_encoder(pd.model_cfg([a])), False) for label, a in pd.SURGERY]
    out.append(("conformer", one_block_encoder(pd.model_cfg(encoder="conformer")), False))
    out += [(label, pd.lm_cfg(n), True) for label, n in pd.LM_BLOCKS]
    return out


@pytest.mark.parametrize("label,cfg,text", variant_cfgs(), ids=[v[0] for v in variant_cfgs()])
def test_decode_tool_variants_build_jax_shapes(label, cfg, text):
    assert port_param_shapes(cfg) == jax_param_shapes(cfg, text)


# --------------------------------------------------------------- the runs
def test_profile_decode_runs_on_cpu():
    rec, text = run_tool("torch_profile_decode",
                         ["--quick", "-b", "2", "--frames", "40", "--iters", "1",
                          "--device", "cpu"])
    assert "per-step (slope)" in text
    assert rec["device"] == "cpu" and [s["max_len"] for s in rec["searches"]] == [24, 4]
    assert "cpu_ms" in rec["encode"] and "device_ms" not in rec["encode"]
    assert np.isfinite(rec["per_step"]["cpu_ms"])


def test_profile_train_runs_on_cpu(tiny_conf, tmp_path):
    rec, text = run_tool("torch_profile_train",
                         ["-b", str(B), "-t", str(T), "-u", str(U), "--iters", "1", "--top",
                          "5", "--config", tiny_conf, "--trace-dir", str(tmp_path),
                          "--device", "cpu"])
    assert "CPU self time" in text and "device_ms" not in rec
    assert rec["updates"] == 2 and np.isfinite(rec["last_loss"])
    assert sum(rec["by_category"].values()) == pytest.approx(rec["cpu_self_ms"], rel=1e-9)
    assert os.path.exists(os.path.join(tmp_path, "trace.json"))
    # the trainer's spans under the CPU profile, an update each (one micro-batch an update)
    assert {k: v["n"] for k, v in rec["spans"].items()} == {
        k: 1.0 for k in ("trainer.micro_step", "trainer.features", "trainer.forward",
                         "trainer.backward", "trainer.update", "trainer.wait",
                         "trainer.optimizer")}
    assert "the trainer's spans, an update: trainer.features 1x" in text


@pytest.mark.parametrize("paced", [False, True], ids=["saturated", "paced"])
def test_stream_latency_finals_every_stream(paced):
    rec, _ = run_tool("torch_stream_latency",
                      ["-n", "4", "--seconds", "1", "--device", "cpu"]
                      + (["--paced"] if paced else []))
    assert rec["finals"] == 4 and rec["ticks"] > 0 and rec["clock"] == "cpu"
    assert rec["mode"] == ("paced" if paced else "saturated")


def test_probe_decode_precision_f32_ids_match_jax(tmp_path, one_torch_thread):
    out = str(tmp_path / "probe.jsonl")
    # the tool pads its batch to 128 rows (JAX's rule): a beam search of 640
    # rows, which wants torch's threads
    torch.set_num_threads(one_torch_thread)
    try:
        _, text = run_tool("torch_probe_decode_precision",
                           ["--utts", "8", "--probes", "f32", "--out", out, "--device", "cpu"])
    finally:
        torch.set_num_threads(1)
    assert text.strip().splitlines()[-1] == "ALL PROBES DONE"
    with open(out) as f:
        rec = json.loads(f.readline())
    assert rec["probe"] == "f32" and rec["utts"] == 8 and rec["ids_off_jax"] <= 1
    assert rec["cer_pct"] < 5.0


def xla_update_flops(cfg: dict) -> float:
    """XLA's ``cost_analysis()["flops"]`` of JAX's one update (forward,
    backward, clip, Adam) of ``cfg`` at B x T x U, as the JAX probe builds it."""
    import jax
    import jax.numpy as jnp

    from opentransformer_tpu.models.registry import build_model as jax_build_model
    from opentransformer_tpu.train.trainer import Trainer as JaxTrainer

    model = jax_build_model(cfg["model"], dtype=jnp.bfloat16)
    trainer = JaxTrainer(dict(cfg["train"], accum_steps=1), model, log_interval=10 ** 9)
    trainer._update_fn = trainer._build_update_fn()
    update_core = trainer._update_core
    tgt = np.ones((B, U + 2), np.int32)
    tgt[:, 1:-1] = np.random.default_rng(2).integers(3, 50, (B, U))
    tgt, tlen, mask = jnp.asarray(tgt), jnp.full((B,), U + 1, jnp.int32), jnp.ones((B, T), bool)

    def single(variables, opt_state, nan_skips, lr, k):
        kf, kd, ku = jax.random.split(k, 3)
        feats = jax.random.normal(kf, (B, T, 40), jnp.float32)

        def loss_fn(p):
            loss, _ = model.apply({"params": p}, feats, mask, tgt, tlen, deterministic=False,
                                  rngs={"dropout": kd}, train=True)
            return loss
        loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
        gacc = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
        return update_core(variables, opt_state, gacc, nan_skips, lr, ku)[:3] + (loss,)

    batch = (None, {"inputs": jnp.zeros((B, T, 40), jnp.float32), "mask": mask},
             {"targets": tgt, "targets_length": tlen})
    state = jax.eval_shape(lambda: trainer.init_state(jax.random.PRNGKey(0), batch))
    lowered = jax.jit(single).lower(state.params, state.opt_state, state.nan_skips,
                                    jnp.float32(1e-4), jax.random.PRNGKey(0))
    c = lowered.compile().cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else c
    return float(c["flops"])


def test_cost_analysis_counts_and_xla_band(tiny_conf):
    rec, _ = run_tool("torch_probe_cost_analysis",
                      ["-b", str(B), "-t", str(T), "-u", str(U), "--time-iters", "1",
                       "--config", tiny_conf, "--device", "cpu"])
    assert rec["accum4"] == 4 * rec["single"]
    assert rec["steps_per_exec20"] == 20 * rec["single"]
    assert "mfu" not in rec and "cpu_update_ms" in rec
    ratio = rec["single"] / xla_update_flops(TINY)
    assert XLA_BAND[0] <= ratio <= XLA_BAND[1], ratio


def test_tools_need_a_card_unless_told_cpu(monkeypatch):
    """Without a card and without ``--device cpu`` every tool refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("torch_profile_decode", ["--quick"]),
                       ("torch_profile_train", ["--iters", "1"]),
                       ("torch_stream_latency", ["-n", "1"]),
                       ("torch_probe_decode_precision", ["--utts", "1"]),
                       ("torch_probe_cost_analysis", ["--time-iters", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool(name).main(argv)


# ------------------------------------------------------------ the recipes
RECIPES = ["egs/synth_bench/run_torch.sh", "egs/synth_bench/continue_torch.sh",
           "egs/synth_bench/ablate_torch.sh", "egs/aishell/run_torch.sh"]
JAX_ENTRY = (r"\b(run|eval|serve|test|bench)\.py\b", r"opentransformer_tpu\.(?!_torch)",
             r"\btools/(?!torch_)\w+\.py\b", r"__graft_entry__")


def python_commands(path: str) -> list[list[str]]:
    """The script's ``python`` commands as argv lists (continuations joined;
    a variable stands as ``1``, ``$dev_args`` and ``"$@"`` as nothing)."""
    import re
    import shlex

    with open(os.path.join(REPO, path)) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        m = re.search(r"(?:^|[;&(]\s*|\s)python\s+(.*)", line.split("#", 1)[0]
                      if not line.lstrip().startswith("python") else line)
        if not m or line.lstrip().startswith("#"):
            continue
        cmd = m.group(1).replace('"$@"', "").replace("$dev_args", "")
        cmd = re.split(r"\s(?:2>&1|\||\))", " " + cmd)[0]
        cmd = re.sub(r"\$\{[^}]*\}|\$\w+", "1", cmd)
        argv = shlex.split(cmd)
        argv[-1] = argv[-1].rstrip(")")  # the end of a ( cd ... && python ... ) group
        out.append(argv)
    return out


def port_parser(argv: list):
    """(the port's parser of a command, its arguments), or None for a
    script the port does not own (the AISHELL recipe's ``local/*.py``)."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data import synth

    if argv[0] == "-m":
        mods = {"opentransformer_tpu_torch.cli.run": run_cli,
                "opentransformer_tpu_torch.cli.eval": eval_cli,
                "opentransformer_tpu_torch.data.synth": synth}
        return mods[argv[1]].build_argparser(), argv[2:]
    if argv[0].startswith("tools/torch_"):
        name = os.path.basename(argv[0])[:-3]
        mod = tool(name)
        if name == "torch_average":
            from opentransformer_tpu_torch.cli import average
            return average.build_argparser(), argv[1:]
        return mod.build_argparser(), argv[1:]
    assert argv[0].startswith("local/"), argv
    return None


@pytest.mark.parametrize("path", RECIPES)
def test_recipe_parses_through_the_port(path):
    import re
    import subprocess

    assert subprocess.run(["bash", "-n", os.path.join(REPO, path)]).returncode == 0
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    for pattern in JAX_ENTRY:
        assert not re.search(pattern, text), (path, pattern)
    commands = python_commands(path)
    owned = 0
    for argv in commands:
        parsed = port_parser(argv)
        if parsed is not None:
            parser, args = parsed
            parser.parse_args(args)
            owned += 1
    assert owned >= 3 if "ablate" not in path else owned == 2
