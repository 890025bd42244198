"""The mixture-of-experts configs at full width with seeded weights, in both
the JAX package and the PyTorch port, on the CPU, in float32.

    python tools/torch_port_moe_parity.py
    python tools/torch_port_moe_parity.py --write

1. ``conf/transformer_moe.json`` (the aishell MoE speech-transformer) with
   ``chip_smoke.seeded_params`` weights on the 16 seeded utterances of
   ``chip_smoke.MOE_INPUTS`` (300-500 frames x 40 mel): the encoder memory
   projected on a seeded unit vector, teacher-forced log-probs, each MoE
   layer's load-balance loss and routing (every choice's expert, kept or
   dropped; ``chip_smoke.routing_code``), and the beam-5 1-best ids over 24
   forced steps (EOS disabled).
2. ``conformer_streaming`` with a drop-free MoE second FFN
   (``chip_smoke.MOE_STREAM``), seeded weights, the 16 utterances and probe
   of ``conformer_seeded.jax.json``: the memory streamed through
   ``MultiStreamAttention`` (16 staggered slots) projected on the probe, and
   the greedy ids of a ``ctc`` model of the same encoder through
   ``MultiStreamCTC``.

JAX's routing is read from JAX's own computation (``jax_routing``): the
router's logits as flax captures them, and the kept choices from a copy of
the layer whose experts each output their own one-hot. Fails when the
port's CPU path is off JAX by more than ``chip_smoke``'s limits; ``--write``
then writes JAX's numbers, seeds, configs and checksums (no weights) as the
fixtures that ``chip_smoke.py`` phases 15a and 15e hold the card to:
``egs/synth_bench/trained/transformer_moe_seeded.jax.json`` and
``conformer_streaming_moe.jax_stream.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from opentransformer_tpu.models.modules import MoEFeedForward as JaxMoE  # noqa: E402
from opentransformer_tpu.models.registry import build_model as jax_build_model  # noqa: E402
from opentransformer_tpu.recognize import multistream as jax_ms  # noqa: E402
from opentransformer_tpu.recognize.base import make_memory_search  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402


def jax_moe_calls(fn):
    """``fn()`` with every JAX ``MoEFeedForward`` call recorded → (its
    result, [(layer name as the port's, e.g. ``encoder.block_1.moe``, the
    layer's config and params, x, pad_mask, aux)])."""
    calls = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if isinstance(mod, JaxMoE) and context.method_name == "__call__":
            params = jax.tree_util.tree_map(np.asarray, dict(mod.variables["params"]))
            calls.append((".".join(mod.path), mod, params, np.asarray(args[0]),
                          kwargs.get("pad_mask"), float(out[1])))
        return out

    with nn.intercept_methods(interceptor):
        result = fn()
    return result, calls


def jax_routing(mod, params, x, pad_mask=None):
    """JAX's routing of x by the MoE layer ``mod`` (its config) with
    ``params`` → (experts int[k, B, T], kept bool[k, B, T]). The experts
    come from the router logits flax captures (first maximum, then the
    maximum of the rest, as the layer picks them); a token's choice is kept
    where a copy of the layer whose expert e outputs the one-hot of e (w1 =
    w2 = 0, b1 = 1 through a relu, b2 = I) gives it a nonzero weight."""
    e, d = mod.n_experts, x.shape[-1]
    sig = JaxMoE(d, e, n_experts=e, top_k=mod.top_k, capacity_factor=mod.capacity_factor,
                 activation="relu")
    sp = {"router": params["router"], "w1": np.zeros((e, d, e), np.float32),
          "b1": np.ones((e, e), np.float32), "w2": np.zeros((e, e, d), np.float32),
          "b2": np.eye(e, d, dtype=np.float32)}
    pm = None if pad_mask is None else jnp.asarray(pad_mask)
    (y, _), inter = jax.jit(lambda p, x, m: sig.apply(
        {"params": p}, x, pad_mask=m, capture_intermediates=True, mutable=["intermediates"]))(
        sp, jnp.asarray(x), pm)
    probs = jax.nn.softmax(inter["intermediates"]["router"]["__call__"][0], axis=-1)
    valid = (jnp.ones(x.shape[:2], jnp.float32) if pm is None else pm.astype(jnp.float32))
    experts, kept, remaining = [], [], probs
    y = np.asarray(y)[..., :e]
    for _ in range(mod.top_k):
        idx = jnp.argmax(remaining, axis=-1)
        remaining = remaining * (1.0 - jax.nn.one_hot(idx, e) * valid[..., None])
        idx = np.asarray(idx)
        experts.append(idx)
        kept.append((np.take_along_axis(y, idx[..., None], -1)[..., 0] > 0)
                    & np.asarray(valid, bool))
    return np.stack(experts), np.stack(kept)


def jax_layers(calls) -> tuple[dict, dict]:
    """{layer: aux}, {layer: routing code} of recorded JAX MoE calls."""
    aux, codes = {}, {}
    for name, mod, params, x, pm, loss in calls:
        experts, kept = jax_routing(mod, params, x, pm)
        valid = np.ones(x.shape[:2], bool) if pm is None else np.asarray(pm)
        aux[name] = loss
        codes[name] = chip_smoke.routing_code(experts, kept, valid)
    return aux, codes


def jax_moe_outputs(cfg: dict, params: dict, feats, mask, targets, c: dict) -> dict:
    """The JAX package's memory projection, log-probs, per-layer aux and
    routing, and 1-best ids (as ``chip_smoke.moe_outputs``)."""
    jm = jax_build_model(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, params)
    (memory, memory_mask), calls = jax_moe_calls(lambda: jm.apply(
        variables, jnp.asarray(feats), jnp.asarray(mask), method="encode"))
    aux, routing = jax_layers(calls)
    proj = memory @ chip_smoke.memory_probe(memory.shape[-1], c["probe_seed"])
    tg = jnp.asarray(targets, jnp.int32)
    logits = jm.apply(variables, tg[:, :-1], memory, memory_mask, method="decode_full")
    logp = jnp.take_along_axis(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1),
                               tg[:, 1:, None], axis=-1)[..., 0]
    hyp = make_memory_search(jm, c["beam"], c["steps"], eos_id=-1)(variables, memory,
                                                                   memory_mask)
    return {"memory": np.asarray(proj), "memory_mask": np.asarray(memory_mask),
            "logp": np.asarray(logp), "ids": np.asarray(hyp.tokens)[:, 0, 1:], "aux": aux,
            "routing": routing}


def speech_fixture() -> tuple[dict, bool]:
    c = dict(chip_smoke.MOE_INPUTS)
    feats, mask, targets = chip_smoke.conformer_inputs(
        c["inputs_seed"], c["utts"], c["frames"], c["min_frames"], c["min_units"],
        c["max_units"], c["mel"])
    cfg = chip_smoke.conformer_model_cfg(chip_smoke.MOE_NAME)
    model = build_model(cfg, device="cpu")
    params = chip_smoke.seeded_params(model, c["weights_seed"])
    from opentransformer_tpu_torch import compat

    compat.load_into(model, params)
    jout = jax_moe_outputs(cfg, params, feats, mask, targets, c)
    tout = chip_smoke.moe_outputs(model, feats, mask, targets, c)
    frames = jout["memory_mask"].sum(axis=1)
    ulen = (targets[:, 1:] != 0).sum(axis=1)
    want = {"memory": [[round(float(x), 6) for x in row[:n]]
                       for row, n in zip(jout["memory"], frames)],
            "logp": [[round(float(x), 6) for x in row[:n]] for row, n in zip(jout["logp"], ulen)],
            "ids": jout["ids"].tolist(), "aux": jout["aux"], "routing": jout["routing"]}
    got = chip_smoke.moe_parity(tout, want, cfg["encoder"]["moe_top_k"])
    kept = np.mean([np.char.isdigit(np.array(list(code))).mean()
                    for code in want["routing"].values()])
    print(f"{chip_smoke.MOE_NAME}: {sum(x.numel() for x in model.parameters())} parameters; "
          f"JAX per-layer aux {want['aux']}; {100 * kept:.2f}% of JAX's choices kept; port vs "
          f"JAX on the CPU: {got}", flush=True)
    fixture = {"what": "transformer_moe at full width with seeded weights, JAX package on the "
                       "CPU in float32: the encoder memory projected on a seeded unit vector "
                       "(each utterance's frames), teacher-forced log-probs of seeded targets "
                       "(units + EOS), each MoE layer's load-balance loss and routing "
                       "(chip_smoke.routing_code over the valid frames) and beam-5 1-best ids "
                       "over 24 forced steps (EOS disabled)",
               "tool": "tools/torch_port_moe_parity.py --write", "inputs": c, "config": cfg,
               "checksums": {"weights": chip_smoke.checksum(params),
                             "feats": chip_smoke.checksum([feats]),
                             "targets": chip_smoke.checksum([targets])},
               "results": want}
    return fixture, chip_smoke.moe_parity_ok(got)


def stream_fixture() -> tuple[dict, bool]:
    offline = chip_smoke.load_conformer_fixture()
    feats, mask, _ = chip_smoke.fixture_inputs(offline)
    c = {"weights_seed": offline["inputs"]["weights_seed"], "ctc_weights_seed":
         chip_smoke.STREAM_CTC_SEED, "probe_seed": offline["inputs"]["probe_seed"],
         "offline_fixture": os.path.relpath(chip_smoke.CONFORMER_FIXTURE, REPO),
         "chunk_frames": chip_smoke.STREAM_CHUNK_FRAMES}
    from opentransformer_tpu_torch import compat

    models, params = {}, {}
    for key, cfg, seed in (("s2t", chip_smoke.moe_stream_cfg(), c["weights_seed"]),
                           ("ctc", chip_smoke.moe_stream_cfg(ctc=True), c["ctc_weights_seed"])):
        models[key] = build_model(cfg, device="cpu")
        params[key] = chip_smoke.seeded_params(models[key], seed)
        compat.load_into(models[key], params[key])
    probe = chip_smoke.memory_probe(models["s2t"].encoder.d_model, c["probe_seed"])
    n = len(feats)
    jm = jax_build_model(chip_smoke.moe_stream_cfg())
    ms = jax_ms.MultiStreamAttention(jm, jax.tree_util.tree_map(jnp.asarray, params["s2t"]),
                                     n_streams=n, **chip_smoke.STREAM_SEARCH)
    slots, _ = chip_smoke.staggered(ms, feats, mask)
    memory = [np.asarray(ms._mem[slots[i]].view(), np.float32) @ probe for i in range(n)]
    jc = jax_build_model(chip_smoke.moe_stream_cfg(ctc=True))
    ms = jax_ms.MultiStreamCTC(jc, jax.tree_util.tree_map(jnp.asarray, params["ctc"]),
                               n_streams=n)
    _, finals = chip_smoke.staggered(ms, feats, mask)
    fixture = {"what": "conformer_streaming with a drop-free MoE second FFN (4 experts, top-2, "
                       "capacity 2.0) at full width with seeded weights and the utterances and "
                       "probe of conformer_seeded.jax.json, JAX package on the CPU in float32: "
                       "the encoder memory streamed through MultiStreamAttention (16 staggered "
                       "slots) projected on the probe; greedy ids of a ctc model of the same "
                       "encoder with a seeded head through MultiStreamCTC (16 staggered slots)",
               "tool": "tools/torch_port_moe_parity.py --write", "inputs": c,
               "config": chip_smoke.moe_stream_cfg(),
               "checksums": {"weights": chip_smoke.checksum(params["s2t"]),
                             "ctc_weights": chip_smoke.checksum(params["ctc"])},
               "stream": {"memory": [[round(float(x), 6) for x in m] for m in memory]},
               "ctc": {"ids": [[int(x) for x in finals[i].split()] for i in range(n)]}}
    out = chip_smoke.moe_stream_outputs(models["s2t"], models["ctc"], feats, mask, probe)
    got = chip_smoke.moe_stream_parity(out, fixture)
    off = chip_smoke.offline_memory_err(models["s2t"], feats, mask, out["session_mem"])
    print(f"MoE conformer_streaming: port vs JAX on the CPU: {got}; the port's streamed memory "
          f"vs its offline chunk-masked encode max|d| {off:.3e}; JAX's CTC id lengths "
          f"{[len(x) for x in fixture['ctc']['ids']]}", flush=True)
    ok = (max(got["session"], got["multi"]) <= chip_smoke.STREAM_MEMORY_ATOL
          and got["frames_differ"] == 0 and got["ctc_differ"] <= chip_smoke.STREAM_CTC_ID_LIMIT
          and off <= chip_smoke.STREAM_OFFLINE_ATOL)
    return fixture, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", action="store_true",
                   help="write the JAX package's numbers as the two fixtures")
    args = p.parse_args(argv)
    results = [(chip_smoke.MOE_FIXTURE, *speech_fixture()),
               (chip_smoke.MOE_STREAM_FIXTURE, *stream_fixture())]
    bad = [os.path.basename(path) for path, _, ok in results if not ok]
    if bad:
        print(f"the port's CPU path disagrees with JAX beyond the limits on {bad}")
        return 1
    if args.write:
        for path, fixture, _ in results:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(fixture, f, separators=(",", ":"))
                f.write("\n")
            print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
