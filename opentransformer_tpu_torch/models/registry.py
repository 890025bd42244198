"""Model registry (counterpart of ``opentransformer_tpu/models/registry.py``).

Builds a model from the ``model`` section of a config, as a dict (read from
JSON: the anchor manifest's ``model_cfg`` is one). The port covers
``speech2text``, ``ctc`` and ``transducer`` with a conv, concat or
Whisper (Conv1d) frontend and a transformer or conformer encoder (absolute
or relative positions, chunked attention, the reference's ``concat_after``
and ``front_end_layer_norm``, the MoE feed-forward; a ``scan_layers``
config builds the same per-block modules), and the language models
``transformer_lm`` (MoE included) and ``rnn_lm``.
"""

from __future__ import annotations

import inspect
import logging

import torch
from torch import nn

from ..utils import disable_tf32, resolve_device
from .lm import RecurrentLanguageModel, TransformerLanguageModel
from .speech2text import ENCODERS, FRONTENDS, CTCModel, SpeechToText
from .transducer import TransducerModel

LM_TYPES = {"transformer_lm": TransformerLanguageModel, "rnn_lm": RecurrentLanguageModel}


def _lm_kwargs(model_cfg: dict, cls) -> dict:
    """The config keys ``cls`` takes, with a warning on keys that are
    dropped. The LM field is ``num_blocks`` while encoders use ``n_blocks``:
    a config that mixes them up would otherwise silently build the
    default-depth LM."""
    fields = [k for k in inspect.signature(cls.__init__).parameters if k != "self"]
    extra = getattr(cls, "TRAINING_FIELDS", ())
    known = (*fields, *extra, "type", "dtype")
    dropped = sorted(k for k in model_cfg if k not in known)
    if dropped:
        logging.getLogger(__name__).warning(
            "%s config keys %s are not model fields and were IGNORED (valid: %s)",
            cls.__name__, dropped, sorted((*fields, *extra)))
    return {k: v for k, v in model_cfg.items() if k in fields}


def build_model(model_cfg: dict, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> nn.Module:
    """Build an inference model on ``device`` (default: the CUDA card, which
    must exist) in ``dtype``. Weights are random until a state dict from
    ``compat.params_from_jax`` is loaded."""
    mtype = model_cfg["type"]
    dev = resolve_device(device)
    if dtype == torch.float32:
        disable_tf32()
    if mtype in LM_TYPES:
        cls = LM_TYPES[mtype]
        return cls(**_lm_kwargs(model_cfg, cls)).to(device=dev, dtype=dtype).eval()
    if mtype not in ("speech2text", "ctc", "transducer"):
        raise ValueError(f"unknown model type {mtype!r}")
    frontend_type = model_cfg.get("frontend_type", "conv")
    encoder_type = model_cfg.get("encoder_type", "transformer")
    if frontend_type not in FRONTENDS:
        raise ValueError(f"unknown frontend_type {frontend_type!r} (known: {sorted(FRONTENDS)})")
    if encoder_type not in ENCODERS:
        raise ValueError(f"unknown encoder_type {encoder_type!r} (known: {sorted(ENCODERS)})")
    if mtype == "speech2text" and model_cfg.get("decoder_type", "transformer") != "transformer":
        raise ValueError(f"unknown decoder_type {model_cfg['decoder_type']!r}")
    lookahead = int(model_cfg.get("lookahead_steps", 0))
    types = {"frontend_type": frontend_type, "encoder_type": encoder_type,
             "moe_aux_weight": float(model_cfg.get("moe_aux_weight", 0.01))}
    if mtype == "transducer":
        model = TransducerModel(
            model_cfg["frontend"], model_cfg["encoder"], int(model_cfg["vocab_size"]),
            predictor_cfg=model_cfg.get("predictor") or {},
            d_joint=int(model_cfg.get("d_joint", model_cfg["encoder"].get("d_model", 256))),
            joint_t_block=int(model_cfg.get("joint_t_block", -1)), **types)
    elif mtype == "ctc":
        model = CTCModel(model_cfg["frontend"], model_cfg["encoder"],
                         int(model_cfg["vocab_size"]), lookahead_steps=lookahead, **types)
    else:
        ctc_weight = float(model_cfg.get("ctc_weight", 0.0))
        if lookahead and ctc_weight <= 0.0:
            raise ValueError("lookahead_steps > 0 belongs to the CTC head: a speech2text model "
                             "has one only with ctc_weight > 0")
        model = SpeechToText(model_cfg["frontend"], model_cfg["encoder"], model_cfg["decoder"],
                             ctc_weight=ctc_weight,
                             smoothing=float(model_cfg.get("smoothing", 0.1)),
                             lookahead_steps=lookahead, **types)
    return model.to(device=dev, dtype=dtype).eval()
