"""Batched beam search with KV caching
(counterpart of ``opentransformer_tpu/recognize/beam.py``).

Same semantics as the JAX reference: per-utterance beams start at
``[0, NEG_INF, ...]``; each step takes the per-row top-k, flattens K·K
candidates and keeps the global top-k (ties to the smallest flat index)
with ``parent = flat // k``; a finished beam keeps exactly one alive branch
at additive 0 that forces EOS; the self-attention caches are append-only
and read through the ancestry map ``src``; the search stops when every
beam has ended; after the loop scores are divided by the length penalty
``((5+len)/6)^0.6`` with len = non-EOS tokens including BOS, and sorted.
With an LM the per-step score is ``logp + lm_weight · lm_logp`` (shallow
fusion), taken either from the fused two-head top-k or from the two
materialized distributions.

The JAX reference runs the loop as one ``lax.while_loop`` on the device;
here it is a Python loop with one host sync per step for the early exit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..data import BOS, EOS
from ..ops.masks import NEG_INF
from ..ops.project_topk import topk_smallest_id


class BeamHypotheses(NamedTuple):
    tokens: torch.Tensor   # long[B, K, U_max+1] (BOS at slot 0), sorted best-first
    scores: torch.Tensor   # f32[B, K] length-penalized log-probs, sorted desc
    lengths: torch.Tensor  # long[B, K] real tokens incl. BOS, excl. EOS


def length_penalty(lengths: torch.Tensor, penalty: float, lamda: float = 5.0) -> torch.Tensor:
    """((lamda + len) / (lamda + 1)) ** penalty."""
    return torch.pow((lamda + lengths.float()) / (lamda + 1.0), penalty)


def _lengths(tokens: torch.Tensor, eos_id: int, max_len: int) -> torch.Tensor:
    """Tokens before the first EOS after BOS, plus BOS."""
    is_eos = tokens[..., 1:] == eos_id
    first = torch.argmax(is_eos.int(), dim=-1)
    return torch.where(is_eos.any(dim=-1), first, max_len) + 1


def _gather_rows(state, rows: torch.Tensor):
    """Reorder the leading axis of every tensor in a nest of lists, tuples
    and dicts (a transformer LM's per-block {"k", "v"}, an LSTM's per-layer
    (c, h))."""
    if isinstance(state, torch.Tensor):
        return state.index_select(0, rows)
    if isinstance(state, dict):
        return {key: _gather_rows(val, rows) for key, val in state.items()}
    return type(state)(_gather_rows(val, rows) for val in state)


def beam_search(
    decode_step: Callable,  # (tokens[B·K], cache, index, mem_mask, src) -> (logp, cache)
    init_cache: Callable,   # (memory, max_len, beam_width) -> cache
    memory: torch.Tensor,   # [B, T, D]
    memory_mask: torch.Tensor,  # bool[B, T]
    beam_width: int,
    max_len: int,
    penalty: float = 0.6,
    lamda: float = 5.0,
    eos_id: int = EOS,
    decode_topk: Optional[Callable] = None,  # (tokens, cache, index, mem_mask, src, k) -> (vals, ids, cache)
    lm_step: Optional[Callable] = None,  # (tokens[N], state, index) -> (logp, state)
    lm_init: Optional[Callable] = None,  # (n) -> state
    lm_weight: float = 0.1,
    decode_topk_lm: Optional[Callable] = None,  # (tokens, cache, lm_state, index, mem_mask, src, k) -> (vals, ids, cache, lm_state)
    lm_ancestral: bool = False,
) -> BeamHypotheses:
    """``eos_id`` overrides the end token (an out-of-vocab id forces every
    decode to run ``max_len`` steps). ``decode_topk`` is the fused
    projection→log-softmax→top-k step, used without an LM instead of
    ``decode_step`` and a top-k over the full log-probs.

    ``lm_step``/``lm_init`` switch shallow fusion on. ``decode_topk_lm`` is
    its fused step: the top-k of ``logp_model + lm_weight · logp_lm`` from
    the two hidden states, neither distribution materialized; without it
    the two log-prob tensors are added and ranked. The LM state follows
    the surviving hypotheses by a gather of its rows each step, unless
    ``lm_ancestral``: then ``decode_topk_lm`` threads the ancestry map into
    the LM, whose caches are append-only like the decoder's."""
    b = memory.shape[0]
    k = beam_width
    dev = memory.device
    cache = init_cache(memory, max_len + 1, k)
    lm_state = lm_init(b * k) if lm_step is not None else None

    tokens = torch.full((b * k, max_len + 1), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = BOS
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    end_flag = torch.zeros((b, k), dtype=torch.bool, device=dev)
    # src[b, k, u] = cache row (within the utterance) holding position u of
    # the hypothesis in slot k; identity at first: each row writes its own
    ident = torch.arange(k, device=dev).expand(b, k)
    src = ident[:, :, None].expand(b, k, max_len + 1).clone()
    fin_vals = torch.full((b * k, k), NEG_INF, dtype=torch.float32, device=dev)
    fin_vals[:, 0] = 0.0
    row_base = torch.arange(b, device=dev)[:, None] * k

    for step in range(max_len):
        if bool(end_flag.all()):
            break
        cur = tokens[:, step]
        if decode_topk_lm is not None and lm_step is not None:
            top_vals, top_idx, cache, lm_state = decode_topk_lm(
                cur, cache, lm_state, step, memory_mask, src, k)
        elif decode_topk is not None and lm_step is None:
            top_vals, top_idx, cache = decode_topk(cur, cache, step, memory_mask, src, k)
        else:
            logp, cache = decode_step(cur, cache, step, memory_mask, src)
            if lm_step is not None:
                lm_logp, lm_state = lm_step(cur, lm_state, step)
                logp = logp + lm_weight * lm_logp
            top_vals, top_idx = topk_smallest_id(logp, k)
        # finished beams: one alive branch with additive score 0, forced EOS
        fin = end_flag.reshape(b * k, 1)
        top_vals = torch.where(fin, fin_vals, top_vals)
        top_idx = torch.where(fin, eos_id, top_idx.long())

        cand = scores[:, :, None] + top_vals.reshape(b, k, k)
        best_scores, best_flat = topk_smallest_id(cand.reshape(b, k * k), k)
        parent = best_flat // k
        tok = torch.gather(top_idx.reshape(b, k * k), 1, best_flat)

        flat_parent = (row_base + parent).reshape(-1)
        tokens = tokens[flat_parent]
        tokens[:, step + 1] = tok.reshape(-1)
        # positions <= step inherit the parent's lineage; step+1 is written
        # by each row itself next iteration
        src = torch.gather(src, 1, parent[:, :, None].expand(b, k, max_len + 1))
        src[:, :, step + 1] = ident
        if lm_state is not None and not lm_ancestral:
            lm_state = _gather_rows(lm_state, flat_parent)
        end_flag = end_flag.reshape(-1)[flat_parent].reshape(b, k) | (tok == eos_id)
        scores = best_scores

    tokens = tokens.reshape(b, k, max_len + 1)
    lengths = _lengths(tokens, eos_id, max_len)
    final = scores / length_penalty(lengths, penalty, lamda)
    final, order = torch.sort(final, dim=1, descending=True, stable=True)
    lengths = torch.gather(lengths, 1, order)
    tokens = torch.gather(tokens, 1, order[:, :, None].expand_as(tokens))
    return BeamHypotheses(tokens=tokens, scores=final, lengths=lengths)


def greedy_search(
    decode_step: Callable,
    init_cache: Callable,
    memory: torch.Tensor,
    memory_mask: torch.Tensor,
    max_len: int,
    eos_id: int = EOS,
    decode_topk: Optional[Callable] = None,
) -> BeamHypotheses:
    """Argmax decoding (beam 1); ``decode_topk`` gives the fused k=1 step,
    with the same smallest-id tie rule as argmax."""
    b = memory.shape[0]
    dev = memory.device
    cache = init_cache(memory, max_len + 1)
    tokens = torch.full((b, max_len + 1), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = BOS
    scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    end_flag = torch.zeros((b,), dtype=torch.bool, device=dev)
    for step in range(max_len):
        if bool(end_flag.all()):
            break
        cur = tokens[:, step]
        if decode_topk is not None:
            vals, idx, cache = decode_topk(cur, cache, step, memory_mask, None, 1)
        else:
            logp, cache = decode_step(cur, cache, step, memory_mask)
            vals, idx = topk_smallest_id(logp, 1)
        tok = torch.where(end_flag, eos_id, idx[:, 0].long())
        scores = scores + torch.where(end_flag, 0.0, vals[:, 0])
        tokens[:, step + 1] = tok
        end_flag = end_flag | (tok == eos_id)
    lengths = _lengths(tokens, eos_id, max_len)
    return BeamHypotheses(tokens=tokens[:, None], scores=scores[:, None],
                          lengths=lengths[:, None])
