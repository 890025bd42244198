"""Weight carry-over from the JAX package to the port.

``params_from_jax`` turns the JAX package's nested parameter dict (numpy
leaves, as ``model.init`` or ``load_npz`` give them) into a state dict for
the port's modules, whose names mirror the flax module paths:

  * a flax ``TorchLinear``'s ``dense`` level disappears into ``nn.Linear``
    (a bare flax ``nn.Dense``, as in the LSTM cell, is a ``modules.Dense``
    and has no such level);
  * Dense ``kernel`` [in, out] → ``weight`` [out, in];
  * Conv ``kernel`` HWIO [kt, kf, in, out] → ``weight`` OIHW, and a 1-d
    Conv ``kernel`` [K, in/groups, out] (the CTC look-ahead conv) →
    ``Conv1d`` ``weight`` [out, in/groups, K];
  * LayerNorm and BatchNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
  * Embed ``embedding`` → ``weight``; other leaves (rel-pos ``posu`` /
    ``posv``) keep their name;
  * a tree that also holds the ``batch_stats`` collection (a conformer with
    BatchNorm conv modules) carries it into buffers: ``mean`` / ``var`` →
    ``running_mean`` / ``running_var``.

``params_to_jax`` is the inverse (used to make seeded random weights in the
JAX layout and to write training checkpoints); a round trip through both
gives back the same state dict. ``load_npz`` reads the ``"//"``-joined npz
export of ``tools/export_trained_synth.py`` (float16 on disk) with numpy
alone, and ``save_npz`` writes that format, in float16 or, for training
checkpoints, float32.

``load_into`` is strict: every parameter and buffer present and no extra one.
``load_ctc_from_speech2text`` loads a ``ctc`` model from a hybrid
speech2text tree (the anchor's): it drops the ``decoder`` scope, and
nothing else.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.modules import BatchNorm, Dense

SEP = "//"
# the JAX package's batch_stats leaves ↔ the port's buffers
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _collections(tree) -> tuple[dict, dict]:
    """(params, batch_stats) of a variables tree ``{"params"[, "batch_stats"]}``
    or of a bare params tree."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX nested params (optionally under a top-level ``params`` key, with
    ``batch_stats`` beside it) → the port's float32 state dict."""
    tree, stats = _collections(tree)
    out = {}
    for path, leaf in _flatten(stats):
        out[".".join(path[:-1] + (_STATS[path[-1]],))] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        segs = [s for s in path if s != "dense"]
        leaf_name = segs[-1]
        if leaf_name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unsupported {arr.ndim}-d kernel at {'/'.join(path)}")
            segs[-1] = "weight"
        elif leaf_name in ("scale", "embedding"):
            segs[-1] = "weight"
        out[".".join(segs)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(model: nn.Module) -> dict:
    """The port's parameters in the JAX package's nested layout (numpy
    float32, under a top-level ``params`` key; BatchNorm running averages
    under ``batch_stats``)."""
    tree: dict = {}

    def put(path, arr):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)

    for mod_name, mod in model.named_modules():
        prefix = ["params"] + (mod_name.split(".") if mod_name else [])
        for p_name, p in mod.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            if isinstance(mod, nn.Linear):
                level = [] if isinstance(mod, Dense) else ["dense"]
                put(prefix + level + ["kernel" if p_name == "weight" else p_name],
                    arr.T if p_name == "weight" else arr)
            elif isinstance(mod, nn.Conv2d):
                put(prefix + ["kernel" if p_name == "weight" else p_name],
                    arr.transpose(2, 3, 1, 0) if p_name == "weight" else arr)
            elif isinstance(mod, nn.Conv1d):
                put(prefix + ["kernel" if p_name == "weight" else p_name],
                    arr.transpose(2, 1, 0) if p_name == "weight" else arr)
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                put(prefix + ["scale" if p_name == "weight" else p_name], arr)
            elif isinstance(mod, nn.Embedding):
                put(prefix + ["embedding"], arr)
            else:
                put(prefix + [p_name], arr)
        stat_names = {v: k for k, v in _STATS.items()}
        for b_name, buf in mod.named_buffers(recurse=False):
            put(["batch_stats"] + prefix[1:] + [stat_names[b_name]],
                buf.detach().float().cpu().numpy())
    return tree


def load_npz(path: str) -> dict:
    """``"//"``-joined flattened npz (float16 or float32 on disk) → nested
    float32 dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key].astype(np.float32)
    return tree


def save_npz(path: str, tree, dtype=np.float16) -> None:
    """Nested parameter dict → ``"//"``-joined flattened npz in ``dtype``
    (float16, the export format, unless asked otherwise; what ``load_npz``
    reads)."""
    np.savez(path, **{SEP.join(keys): np.asarray(leaf, dtype=dtype)
                      for keys, leaf in _flatten(tree)})


def load_into(model: nn.Module, tree) -> nn.Module:
    """Load a JAX-layout parameter tree (``batch_stats`` included) into
    ``model`` (strict: every parameter and buffer must be present and no
    extra one)."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def load_ctc_from_speech2text(model: nn.Module, tree) -> nn.Module:
    """Load a hybrid speech2text tree (frontend, encoder, decoder, ctc) into
    a ``ctc`` model: the ``decoder`` scope is dropped, and every other array
    must match the model's parameters one to one (strict, as ``load_into``)."""
    params, stats = _collections(tree)
    if "decoder" not in params:
        raise KeyError("not a speech2text tree: it has no decoder scope to drop "
                       f"(scopes {sorted(params)})")
    return load_into(model, {"params": {k: v for k, v in params.items() if k != "decoder"},
                             "batch_stats": stats})
