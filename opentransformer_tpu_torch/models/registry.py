"""Model registry (counterpart of ``opentransformer_tpu/models/registry.py``).

Builds a model from the ``model`` section of a config, as a dict (read from
JSON: the anchor manifest's ``model_cfg`` is one). This slice of the port
covers ``speech2text`` with a conv frontend and an absolute-position
transformer encoder; anything else raises and names the ROADMAP queue.
"""

from __future__ import annotations

import torch

from ..utils import disable_tf32, resolve_device
from .speech2text import SpeechToText

# options the port does not implement yet, with the value that means "off"
_NOT_PORTED = {
    "encoder": {"relative_positional": False, "chunk_size": 0, "moe_experts": 0,
                "concat_after": False, "scan_layers": False},
    "decoder": {"concat_after": False, "scan_layers": False},
    "frontend": {"front_end_layer_norm": False},
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to opentransformer_tpu_torch yet "
        "(see ROADMAP.md, Queue 1: modules still to port)")


def build_model(model_cfg: dict, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> SpeechToText:
    """Build an inference model on ``device`` (default: the CUDA card, which
    must exist) in ``dtype``. Weights are random until a state dict from
    ``compat.params_from_jax`` is loaded."""
    mtype = model_cfg["type"]
    if mtype != "speech2text":
        raise _not_ported(f"model type {mtype!r}")
    if model_cfg.get("frontend_type", "conv") != "conv":
        raise _not_ported(f"frontend_type {model_cfg['frontend_type']!r}")
    for part in ("encoder", "decoder"):
        kind = model_cfg.get(f"{part}_type", "transformer")
        if kind != "transformer":
            raise _not_ported(f"{part}_type {kind!r}")
    if int(model_cfg.get("lookahead_steps", 0)):
        raise _not_ported("the CTC look-ahead conv (lookahead_steps > 0)")
    for section, options in _NOT_PORTED.items():
        for key, off in options.items():
            if model_cfg[section].get(key, off) != off:
                raise _not_ported(f"{section} option {key}={model_cfg[section][key]!r}")
    dev = resolve_device(device)
    if dtype == torch.float32:
        disable_tf32()
    model = SpeechToText(model_cfg["frontend"], model_cfg["encoder"], model_cfg["decoder"],
                         ctc_weight=float(model_cfg.get("ctc_weight", 0.0)))
    return model.to(device=dev, dtype=dtype).eval()
