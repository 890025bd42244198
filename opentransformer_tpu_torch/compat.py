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

The JAX package's ``scan_layers`` checkpoints stack a component's blocks
under one ``blocks`` scope with a leading [L] axis. ``params_from_jax``
unstacks such a tree into the port's ``block_0 … block_{L-1}`` modules, and
``params_to_jax`` restacks the components whose module has ``scan_layers``
set; ``to_scan_layout`` and ``from_scan_layout`` convert a tree.

Reference checkpoints (the OpenTransformer ``model.epoch.N.pt`` the JAX
package reads in ``opentransformer_tpu/compat.py``) map straight onto the
port's names, with no JAX tree between: ``convert_reference_checkpoint``
and the two LM converters give a port state dict, ``load_reference_any``
and ``load_reference_checkpoint`` read a ``.pt`` with ``torch.load(...,
weights_only=True)``, and ``export_reference_checkpoint`` writes the
inverse. The reference layout differs from the port's in these ways:

  * q, k, v come fused as ``qvk_proj`` (split in q, k, v order, as the
    port's ``qkv_proj``), the cross-attention's k, v as ``vk_proj``, the
    output projection as ``output_proj``, the FFN as ``feed_forward.w_1/w_2``;
  * both sides are torch modules, so a Linear's [out, in] weight and a
    conv's [O, I, kT, kF] weight map as they are; the rel-pos ``posu`` /
    ``posv`` are [1, 1, H, Dh] there and [1, H, 1, Dh] here;
  * a tied decoder or LM keeps its own output bias (``output_bias``); the
    encoder's final norm is ``norm``, the decoder's ``after_norm``;
  * the reference conformer's trained forward skips its second FFN and the
    attention's output projection (``ref_compat``): import drops them and
    export writes the FFN as zeros; its conv module is always BatchNorm;
  * an LSTM keeps fused [4H, ·] gate matrices (i, f, g, o) and two biases,
    which sum into the port's hidden-side bias; export writes that sum as
    ``bias_hh`` and zeros as ``bias_ih``;
  * the reference has no mixture of experts: importing into an MoE config
    and exporting an MoE model raise (the JAX package's converters fail on
    them too, with a KeyError on export and a tree without the ``moe``
    parameters on import).

An MoE block's parameters (``moe/router/dense/{kernel,bias}`` and the
stacked ``moe/{w1,b1,w2,b2}`` [E, ...], [L, E, ...] in the ``scan_layers``
layout) map like any other: the router is a Linear, and the stacked leaves
keep their name and layout.
"""

from __future__ import annotations

import re

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


def _unstack_blocks(tree):
    """A copy of ``tree`` with every ``blocks`` scope (leaves [L, ...], the
    JAX package's ``scan_layers`` layout) replaced by ``block_0`` …
    ``block_{L-1}``."""
    out = {}
    for key, val in tree.items():
        if not hasattr(val, "items"):
            out[key] = val
        elif key == "blocks":
            n = next(iter(_flatten(val)))[1].shape[0]
            for i in range(n):
                out[f"block_{i}"] = _index_tree(val, i)
        else:
            out[key] = _unstack_blocks(val)
    return out


def _index_tree(tree, i):
    return {k: _index_tree(v, i) if hasattr(v, "items") else np.asarray(v)[i]
            for k, v in tree.items()}


def from_scan_layout(tree, component: str = "encoder") -> dict:
    """Stacked ``blocks`` [L, ...] of ``component`` → ``block_0..L-1``
    (a full variables tree under ``params``, or a bare params tree)."""
    root = dict(tree.get("params", tree))
    comp = dict(root[component])
    stacked = comp.pop("blocks")
    n = next(iter(_flatten(stacked)))[1].shape[0]
    for i in range(n):
        comp[f"block_{i}"] = _index_tree(stacked, i)
    root[component] = comp
    return {**tree, "params": root} if "params" in tree else root


def to_scan_layout(tree, component: str = "encoder", block_prefix: str = "block_") -> dict:
    """``block_0..L-1`` of ``component`` → one ``blocks`` scope whose leaves
    stack the blocks' along a leading [L] axis (the layout of a
    ``scan_layers: true`` model); other keys pass through."""
    root = dict(tree.get("params", tree))
    comp = dict(root[component])
    keys = sorted((k for k in comp if k.startswith(block_prefix)),
                  key=lambda k: int(k[len(block_prefix):]))
    if not keys:
        raise KeyError(f"no '{block_prefix}*' blocks under {component!r}")
    blocks = [comp.pop(k) for k in keys]

    def stack(nodes):
        return {k: stack([n[k] for n in nodes]) if hasattr(nodes[0][k], "items")
                else np.stack([np.asarray(n[k]) for n in nodes]) for k in nodes[0]}

    comp["blocks"] = stack(blocks)
    root[component] = comp
    return {**tree, "params": root} if "params" in tree else root


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX nested params (optionally under a top-level ``params`` key, with
    ``batch_stats`` beside it; ``scan_layers`` blocks unstacked) → the
    port's float32 state dict."""
    tree, stats = _collections(tree)
    tree, stats = _unstack_blocks(tree), _unstack_blocks(stats)
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


def params_to_jax(model: nn.Module, state: dict | None = None) -> dict:
    """The port's parameters in the JAX package's nested layout (numpy
    float32, under a top-level ``params`` key; BatchNorm running averages
    under ``batch_stats``; the blocks of a ``scan_layers`` encoder or
    decoder stacked under ``blocks``). ``state`` (a copy of the model's
    state dict) gives the values in place of the live tensors."""
    tree: dict = {}

    def put(path, arr):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)

    for mod_name, mod in model.named_modules():
        prefix = ["params"] + (mod_name.split(".") if mod_name else [])
        full = (lambda n: f"{mod_name}.{n}") if mod_name else (lambda n: n)
        for p_name, p in mod.named_parameters(recurse=False):
            p = p if state is None else state[full(p_name)]
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
            buf = buf if state is None else state[full(b_name)]
            put(["batch_stats"] + prefix[1:] + [stat_names[b_name]],
                buf.detach().float().cpu().numpy())
    for mod_name, mod in model.named_modules():
        if getattr(mod, "scan_layers", False):
            tree["params"] = to_scan_layout(tree["params"], mod_name)
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


# ------------------------------------------------ reference checkpoints (.pt)
# A name table is a list of (reference name, port name, permute) triples:
# the tensor moves as it is, or with ``permute`` (the rel-pos biases) axes
# 1 and 2 swapped, which is its own inverse.

def _lin(ref: str, port: str) -> list:
    return [(f"{ref}.weight", f"{port}.weight", False), (f"{ref}.bias", f"{port}.bias", False)]


def _attn(ref: str, port: str) -> list:
    return _lin(f"{ref}.qvk_proj", f"{port}.qkv_proj") + _lin(f"{ref}.output_proj",
                                                             f"{port}.out_proj")


def _ffn(ref: str, port: str) -> list:
    return _lin(f"{ref}.w_1", f"{port}.w1") + _lin(f"{ref}.w_2", f"{port}.w2")


def _frontend_names(layer_norm: bool) -> list:
    out = (_lin("conv1.conv_layer", "conv1.conv") + _lin("conv2.conv_layer", "conv2.conv")
           + _lin("output_layer", "output_layer"))
    return out + (_lin("layer_norm", "layer_norm") if layer_norm else [])


def _encoder_names(blocks, concat: bool, final_norm: bool) -> list:
    out = []
    for i in blocks:
        r, p = f"blocks.{i}", f"block_{i}"
        out += (_attn(f"{r}.slf_attn", f"{p}.slf_attn") + _ffn(f"{r}.feed_forward", f"{p}.ffn")
                + _lin(f"{r}.norm1", f"{p}.norm1") + _lin(f"{r}.norm2", f"{p}.norm2"))
        if concat:
            out += _lin(f"{r}.concat_linear", f"{p}.concat_linear")
    # the reference encoder's final (pre-norm) LayerNorm is 'norm'
    return out + (_lin("norm", "after_norm") if final_norm else [])


def _decoder_names(blocks, concat: bool, after_norm: bool, tied: bool) -> list:
    out = [("embedding.weight", "embedding.weight", False)]
    for i in blocks:
        r, p = f"blocks.{i}", f"block_{i}"
        out += (_attn(f"{r}.slf_attn", f"{p}.slf_attn")
                + _lin(f"{r}.src_attn.q_proj", f"{p}.src_attn.q_proj")
                + _lin(f"{r}.src_attn.vk_proj", f"{p}.src_attn.kv_proj")
                + _lin(f"{r}.src_attn.output_proj", f"{p}.src_attn.out_proj")
                + _ffn(f"{r}.feed_forward", f"{p}.ffn"))
        for n in ("norm1", "norm2", "norm3"):
            out += _lin(f"{r}.{n}", f"{p}.{n}")
        if concat:
            out += (_lin(f"{r}.concat_linear1", f"{p}.concat_linear1")
                    + _lin(f"{r}.concat_linear2", f"{p}.concat_linear2"))
    out += _lin("after_norm", "after_norm") if after_norm else []
    if tied:  # the tied output layer's weight is the embedding; its bias is its own
        return out + [("output_layer.bias", "output_bias", False)]
    return out + _lin("output_layer", "output_layer")


def _conformer_names(blocks, relative_positional: bool, ref_compat: bool) -> list:
    out = []
    for i in blocks:
        r, p = f"blocks.{i}", f"block_{i}"
        out += _ffn(f"{r}.pre_ffn", f"{p}.pre_ffn") + _lin(f"{r}.macaron_ffn_norm",
                                                           f"{p}.pre_ffn_norm")
        if relative_positional:
            out += [(f"{r}.mha.pos_proj.weight", f"{p}.slf_attn.pos_proj.weight", False),
                    (f"{r}.mha.posu", f"{p}.slf_attn.posu", True),
                    (f"{r}.mha.posv", f"{p}.slf_attn.posv", True)]
            out += _lin(f"{r}.mha.qvk_proj", f"{p}.slf_attn.qkv_proj")
            if not ref_compat:
                out += _lin(f"{r}.mha.output_proj", f"{p}.slf_attn.out_proj")
        else:
            out += _attn(f"{r}.mha", f"{p}.slf_attn")
        rc, pc = f"{r}.conv", f"{p}.conv_module"
        out += (_lin(f"{r}.mha_norm", f"{p}.attn_norm") + _lin(f"{rc}.pointwise_conv1", f"{pc}.pw1")
                + _lin(f"{rc}.depthwise_conv", f"{pc}.dw_conv")
                + _lin(f"{rc}.batch_norm", f"{pc}.bn")
                + [(f"{rc}.batch_norm.running_{s}", f"{pc}.bn.running_{s}", False)
                   for s in ("mean", "var")]
                + _lin(f"{rc}.pointwise_conv2", f"{pc}.pw2"))
        for ref_n, port_n in (("conv_norm", "conv_norm"), ("post_ffn_norm", "post_ffn_norm"),
                              ("final_norm", "final_norm")):
            out += _lin(f"{r}.{ref_n}", f"{p}.{port_n}")
        if not ref_compat:
            out += _ffn(f"{r}.post_ffn", f"{p}.post_ffn")
    return out


def _ctc_names(lookahead: str | None, lookahead_bias: bool) -> list:
    out = _lin("output_layer", "output_layer")
    if lookahead is not None:
        out.append((f"{lookahead}.weight", "look_ahead_conv.weight", False))
        if lookahead_bias:
            out.append((f"{lookahead}.bias", "look_ahead_conv.bias", False))
    return out


def _transformer_lm_names(blocks, tied: bool) -> list:
    out = [("embedding.weight", "embedding.weight", False)]
    for i in blocks:
        r, p = f"blocks.{i}", f"block_{i}"
        out += (_attn(f"{r}.slf_attn", f"{p}.slf_attn") + _ffn(f"{r}.feed_forward", f"{p}.ffn")
                + _lin(f"{r}.norm1", f"{p}.norm1") + _lin(f"{r}.norm2", f"{p}.norm2"))
    if tied:
        return out + [("output_project.bias", "output_bias", False)]
    return out + _lin("output_project", "output_layer")


def _ref_tensor(x) -> torch.Tensor:
    """A reference array (tensor or numpy) as a float32 CPU tensor of its own."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone().contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _move(src: dict, names: list, to_port: bool, prefix: str = "") -> dict:
    """Apply a name table: reference → port names (under ``prefix``) with
    ``to_port``, else port → reference."""
    out = {}
    for ref, port, permute in names:
        a, b = (ref, prefix + port) if to_port else (prefix + port, ref)
        t = _ref_tensor(src[a])
        out[b] = t.permute(0, 2, 1, 3).contiguous() if permute else t
    return out


def _block_ids(keys, pattern: str) -> list[int]:
    return sorted({int(m.group(1)) for k in keys for m in [re.match(pattern, k)] if m})


def convert_frontend(sd) -> dict:
    return _move(sd, _frontend_names("layer_norm.weight" in sd), True)


def convert_encoder(sd, n_blocks: int) -> dict:
    return _move(sd, _encoder_names(range(n_blocks), "blocks.0.concat_linear.weight" in sd,
                                    "norm.weight" in sd), True)


def convert_decoder(sd, n_blocks: int, share_embedding: bool) -> dict:
    return _move(sd, _decoder_names(range(n_blocks), "blocks.0.concat_linear1.weight" in sd,
                                    "after_norm.weight" in sd, share_embedding), True)


def convert_conformer_encoder(sd, nblocks: int, relative_positional: bool = True,
                              ref_compat: bool = True) -> dict:
    """Reference conformer encoder → the port's state dict, BatchNorm
    running statistics included; with ``ref_compat`` the weights its
    forward never applies (the second FFN, the rel-pos output projection)
    are left out."""
    return _move(sd, _conformer_names(range(nblocks), relative_positional, ref_compat), True)


def _lookahead_key(keys) -> str | None:
    # the reference attribute is 'lookahead_conv'; the underscored spelling is accepted too
    for key in keys:
        if key.endswith(("lookahead_conv.weight", "look_ahead_conv.weight")):
            return key[: -len(".weight")]
    return None


def convert_ctc(sd) -> dict:
    la = _lookahead_key(sd)
    return _move(sd, _ctc_names(la, la is not None and f"{la}.bias" in sd), True)


def _no_moe() -> NotImplementedError:
    return NotImplementedError("the reference has no mixture of experts: an MoE model has no "
                               "reference checkpoint to import or export")


def convert_reference_checkpoint(chkpt, model_cfg: dict) -> dict[str, torch.Tensor]:
    """A reference speech2text checkpoint (component state dicts
    ``frontend``, ``encoder``, ``decoder`` and optionally ``ctc``) → the
    port's state dict for ``model_cfg`` (which has no MoE)."""
    dec_cfg, enc_cfg = model_cfg["decoder"], model_cfg.get("encoder", {})
    if enc_cfg.get("moe_experts", 0) > 0:
        raise _no_moe()
    if model_cfg.get("encoder_type", "transformer") == "conformer":
        encoder = convert_conformer_encoder(
            chkpt["encoder"], int(enc_cfg.get("nblocks", 12)),
            relative_positional=bool(enc_cfg.get("relative_positional", True)),
            ref_compat=bool(enc_cfg.get("ref_compat", True)))
    else:
        encoder = convert_encoder(chkpt["encoder"], int(enc_cfg.get("n_blocks", 6)))
    # the reference classes default to 6 decoder blocks and a tied embedding
    parts = {"frontend": convert_frontend(chkpt["frontend"]), "encoder": encoder,
             "decoder": convert_decoder(chkpt["decoder"], int(dec_cfg.get("n_blocks", 6)),
                                        bool(dec_cfg.get("share_embedding", True)))}
    if chkpt.get("ctc"):
        parts["ctc"] = convert_ctc(chkpt["ctc"])
    return {f"{scope}.{k}": v for scope, sd in parts.items() for k, v in sd.items()}


def convert_transformer_lm(sd, num_blocks: int, share_embedding: bool) -> dict[str, torch.Tensor]:
    """Reference transformer LM state dict → the port's."""
    return _move(sd, _transformer_lm_names(range(num_blocks), share_embedding), True)


LSTM_GATES = "ifgo"  # torch's gate order in weight_ih / weight_hh


def convert_rnn_lm(sd, num_layers: int, share_embedding: bool) -> dict[str, torch.Tensor]:
    """Reference LSTM LM → the port's: each layer's fused [4H, ·] matrices
    split per gate (i, f, g, o), the two biases summed into the hidden side."""
    out = {"embedding.weight": _ref_tensor(sd["embedding.weight"])}
    for layer in range(num_layers):
        w_ih = _ref_tensor(sd[f"rnn.weight_ih_l{layer}"])
        w_hh = _ref_tensor(sd[f"rnn.weight_hh_l{layer}"])
        b = _ref_tensor(sd[f"rnn.bias_ih_l{layer}"]) + _ref_tensor(sd[f"rnn.bias_hh_l{layer}"])
        for g, wi, wh, bh in zip(LSTM_GATES, w_ih.chunk(4), w_hh.chunk(4), b.chunk(4)):
            cell = f"lstm_{layer}.cell"
            out[f"{cell}.i{g}.weight"] = wi.contiguous()
            out[f"{cell}.h{g}.weight"] = wh.contiguous()
            out[f"{cell}.h{g}.bias"] = bh.contiguous()
    if share_embedding:
        out["output_bias"] = _ref_tensor(sd["output_project.bias"])
    else:
        out.update(_move(sd, _lin("output_project", "output_layer"), True))
    return out


def _convert_lm_chkpt(chkpt) -> tuple[dict, dict]:
    cfg = chkpt.get("params", {})
    mc = cfg.get("model", cfg)
    sd = chkpt["model"]
    tied = bool(mc.get("share_embedding", True))
    if mc.get("type") == "rnn_lm" or any(k.startswith("rnn.") for k in sd):
        return convert_rnn_lm(sd, int(mc.get("num_layers", 2)), tied), cfg
    return convert_transformer_lm(sd, int(mc.get("num_blocks", 6)), tied), cfg


def _compat_cfg(cfg: dict) -> dict:
    """A reference-embedded config adjusted so that the model it builds here
    is the one the reference trained: its conformer always used BatchNorm,
    and its forward skipped the second FFN and the output projection
    (``ref_compat``)."""
    mc = cfg.get("model")
    if isinstance(mc, dict) and mc.get("encoder_type") == "conformer":
        enc = dict(mc.get("encoder", {}))
        enc.setdefault("conv_norm_type", "batch")
        enc.setdefault("ref_compat", True)
        cfg = {**cfg, "model": {**mc, "encoder": enc}}
    return cfg


def read_reference(path: str) -> dict:
    """``torch.load`` of a reference ``.pt`` with ``weights_only=True``: its
    payload is dicts, tensors and plain values. A file that needs more is
    refused, by name, and never loaded unsafely."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch raises UnpicklingError or RuntimeError here
        raise ValueError(f"{path}: not loadable as a reference checkpoint with "
                         f"weights_only=True ({type(e).__name__}: {e})") from e


def load_reference_checkpoint(path: str, model_cfg: dict | None = None) -> tuple[dict, dict]:
    """A reference speech2text ``model.epoch.N.pt`` → (the port's state
    dict, its embedded config adjusted by ``_compat_cfg``); ``model_cfg``
    overrides the embedded model section for the conversion."""
    chkpt = read_reference(path)
    cfg = _compat_cfg(chkpt.get("params", {}))
    return convert_reference_checkpoint(chkpt, model_cfg or cfg.get("model", cfg)), cfg


def load_reference_any(path: str, model_cfg: dict | None = None) -> tuple[dict, dict]:
    """Any reference ``.pt``: a speech2text checkpoint (component state
    dicts) or an LM's (one ``model`` state dict) → (the port's state dict,
    embedded config)."""
    chkpt = read_reference(path)
    if "model" in chkpt and "encoder" not in chkpt:
        return _convert_lm_chkpt(chkpt)
    cfg = _compat_cfg(chkpt.get("params", {}))
    return convert_reference_checkpoint(chkpt, model_cfg or cfg.get("model", cfg)), cfg


# export: the port's state dict → the reference's .pt payload

def _sub(state: dict, scope: str) -> dict:
    return {k[len(scope) + 1:]: v for k, v in state.items() if k.startswith(scope + ".")}


def export_frontend(sd: dict) -> dict:
    return _move(sd, _frontend_names("layer_norm.weight" in sd), False)


def export_encoder(sd: dict) -> dict:
    blocks = _block_ids(sd, r"block_(\d+)\.")
    return _move(sd, _encoder_names(blocks, "block_0.concat_linear.weight" in sd,
                                    "after_norm.weight" in sd), False)


def export_decoder(sd: dict) -> dict:
    blocks = _block_ids(sd, r"block_(\d+)\.")
    tied = "output_bias" in sd
    out = _move(sd, _decoder_names(blocks, "block_0.concat_linear1.weight" in sd,
                                   "after_norm.weight" in sd, tied), False)
    if tied:  # the tied output layer's weight aliases the embedding
        out["output_layer.weight"] = out["embedding.weight"].clone()
    return out


def export_ctc(sd: dict) -> dict:
    la = "lookahead_conv" if "look_ahead_conv.weight" in sd else None
    return _move(sd, _ctc_names(la, "look_ahead_conv.bias" in sd), False)


def export_conformer_encoder(sd: dict, enc_cfg: dict) -> dict:
    """A ``ref_compat`` BatchNorm conformer → the reference's state dict.
    The second FFN, which the reference's forward never applies, is written
    as zeros so that its strict ``load_state_dict`` succeeds, and the
    BatchNorm's ``num_batches_tracked`` as 0."""
    d_model = int(enc_cfg.get("d_model", 256))
    d_ff = int(enc_cfg.get("d_ff", 2048))
    blocks = _block_ids(sd, r"block_(\d+)\.")
    out = _move(sd, _conformer_names(blocks, bool(enc_cfg.get("relative_positional", True)),
                                     True), False)
    w1_out = 2 * d_ff if enc_cfg.get("activation", "glu") == "glu" else d_ff
    for i in blocks:
        r = f"blocks.{i}"
        out[f"{r}.conv.batch_norm.num_batches_tracked"] = torch.zeros(())
        out[f"{r}.post_ffn.w_1.weight"] = torch.zeros(w1_out, d_model)
        out[f"{r}.post_ffn.w_1.bias"] = torch.zeros(w1_out)
        out[f"{r}.post_ffn.w_2.weight"] = torch.zeros(d_model, d_ff)
        out[f"{r}.post_ffn.w_2.bias"] = torch.zeros(d_model)
    return out


def export_transformer_lm(sd: dict) -> dict:
    tied = "output_bias" in sd
    out = _move(sd, _transformer_lm_names(_block_ids(sd, r"block_(\d+)\."), tied), False)
    if tied:
        out["output_project.weight"] = out["embedding.weight"].clone()
    return out


def export_rnn_lm(sd: dict) -> dict:
    """The port's LSTM LM → the reference's: the per-gate matrices fused in
    (i, f, g, o) order, the hidden-side bias as ``bias_hh`` and zeros as
    ``bias_ih`` (torch sums the two)."""
    out = {"embedding.weight": _ref_tensor(sd["embedding.weight"])}
    for layer in _block_ids(sd, r"lstm_(\d+)\."):
        cell = f"lstm_{layer}.cell"
        b = torch.cat([_ref_tensor(sd[f"{cell}.h{g}.bias"]) for g in LSTM_GATES])
        out[f"rnn.weight_ih_l{layer}"] = torch.cat([_ref_tensor(sd[f"{cell}.i{g}.weight"])
                                                    for g in LSTM_GATES])
        out[f"rnn.weight_hh_l{layer}"] = torch.cat([_ref_tensor(sd[f"{cell}.h{g}.weight"])
                                                    for g in LSTM_GATES])
        out[f"rnn.bias_ih_l{layer}"] = torch.zeros_like(b)
        out[f"rnn.bias_hh_l{layer}"] = b
    if "output_bias" in sd:
        out["output_project.weight"] = out["embedding.weight"].clone()
        out["output_project.bias"] = _ref_tensor(sd["output_bias"])
    else:
        out.update(_move(sd, _lin("output_project", "output_layer"), False))
    return out


def export_reference_checkpoint(state, cfg: dict) -> dict:
    """The port's state dict (or a model) and its config → the reference's
    ``.pt`` payload: ``{"params": cfg, "frontend", "encoder", "decoder"[,
    "ctc"]}`` for a speech2text model with a transformer or ``ref_compat``
    BatchNorm conformer encoder, ``{"params": cfg, "model"}`` for an LM.
    Any other model, and an MoE one, raises, as the JAX package's export does."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    if any(".moe." in k or k.startswith("moe.") for k in state):
        raise _no_moe()
    mc = cfg.get("model", cfg)
    mtype = mc.get("type", "speech2text")
    if mtype == "transformer_lm":
        return {"params": dict(cfg), "model": export_transformer_lm(state)}
    if mtype == "rnn_lm":
        return {"params": dict(cfg), "model": export_rnn_lm(state)}
    enc_type = mc.get("encoder_type", "transformer")
    if mtype != "speech2text" or enc_type not in ("transformer", "conformer"):
        raise NotImplementedError(
            "the reference export covers the speech2text family (transformer or ref_compat "
            f"conformer encoder) and LMs (got type={mtype!r}, encoder_type={enc_type!r})")
    enc_sd = _sub(state, "encoder")
    if enc_type == "conformer":
        enc_cfg = mc.get("encoder", {})
        if not enc_cfg.get("ref_compat", False) or enc_cfg.get("conv_norm_type") != "batch":
            raise NotImplementedError(
                "conformer export requires ref_compat: true and conv_norm_type: batch (the "
                "model the reference trains and loads); the fixed-architecture variant has no "
                "reference equivalent")
        encoder = export_conformer_encoder(enc_sd, enc_cfg)
    else:
        encoder = export_encoder(enc_sd)
    chkpt = {"params": dict(cfg), "frontend": export_frontend(_sub(state, "frontend")),
             "encoder": encoder, "decoder": export_decoder(_sub(state, "decoder"))}
    ctc = _sub(state, "ctc")
    if ctc:
        chkpt["ctc"] = export_ctc(ctc)
    return chkpt
