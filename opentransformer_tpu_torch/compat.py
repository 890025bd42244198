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
  * LayerNorm ``scale`` / ``bias`` → ``weight`` / ``bias``;
  * Embed ``embedding`` → ``weight``; other leaves keep their name.

``params_to_jax`` is the inverse (used to make seeded random weights in the
JAX layout and to write training checkpoints); a round trip through both
gives back the same state dict. ``load_npz`` reads the ``"//"``-joined npz
export of ``tools/export_trained_synth.py`` (float16 on disk) with numpy
alone, and ``save_npz`` writes that format, in float16 or, for training
checkpoints, float32.

``load_into`` is strict: every parameter present and no extra one.
``load_ctc_from_speech2text`` loads a ``ctc`` model from a hybrid
speech2text tree (the anchor's): it drops the ``decoder`` scope, and
nothing else.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.modules import Dense

SEP = "//"


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX nested params (optionally under a top-level ``params`` key) →
    the port's float32 state dict."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out = {}
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
    float32, under a top-level ``params`` key)."""
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
            elif isinstance(mod, nn.LayerNorm):
                put(prefix + ["scale" if p_name == "weight" else p_name], arr)
            elif isinstance(mod, nn.Embedding):
                put(prefix + ["embedding"], arr)
            else:
                put(prefix + [p_name], arr)
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
    """Load a JAX-layout parameter tree into ``model`` (strict: every
    parameter must be present and no extra one)."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def load_ctc_from_speech2text(model: nn.Module, tree) -> nn.Module:
    """Load a hybrid speech2text tree (frontend, encoder, decoder, ctc) into
    a ``ctc`` model: the ``decoder`` scope is dropped, and every other array
    must match the model's parameters one to one (strict, as ``load_into``)."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    if "decoder" not in tree:
        raise KeyError("not a speech2text tree: it has no decoder scope to drop "
                       f"(scopes {sorted(tree)})")
    return load_into(model, {k: v for k, v in tree.items() if k != "decoder"})
