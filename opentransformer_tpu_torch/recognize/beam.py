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
The search takes one ``step`` callable, which scores the beams' next
tokens and returns their per-row top-k; what it scores with (the fused
kernel, materialized log-probs, an LM fused into either) is chosen by its
maker (``recognize.base.make_memory_search``), once a search.

The JAX reference runs the loop as one ``lax.while_loop`` on the device;
here it is a Python loop with one host sync per step for the early exit.
Under a ``torch.profiler`` session the search records its spans
(``profiling.span``): ``beam.search`` around it all, and a step's
``beam.wait`` (that sync), ``beam.decode`` (the decoder step through its
top-k, timed on the device too) and ``beam.select`` (the beam's
book-keeping).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import profiling
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


@profiling.spanned("beam.search")
def beam_search(
    step: Callable,        # (tokens[B·K], state, index, mem_mask, src, k) -> (vals, ids, state)
    init_state: Callable,  # (memory, beam_width) -> state
    memory: torch.Tensor,  # [B, T, D]
    memory_mask: torch.Tensor,  # bool[B, T]
    beam_width: int,
    max_len: int,
    penalty: float = 0.6,
    lamda: float = 5.0,
    eos_id: int = EOS,
    reorder: Optional[Callable] = None,  # (state, flat_parent long[B·K]) -> state
) -> BeamHypotheses:
    """``step`` gives each row's top-k next tokens (f32 log-prob scores
    sorted descending, their ids) and the state after the step. The state
    (the decoder's caches, and an LM's state with shallow fusion) is built
    by ``init_state`` for ``memory.shape[0] · beam_width`` rows. The
    decoder's caches are append-only and read through the ancestry map
    ``src``; ``reorder`` gathers the rows of a state that is not (an LM
    state that follows the surviving hypotheses) after each step, with the
    parent row of every slot. ``eos_id`` overrides the end token (an
    out-of-vocab id forces every decode to run ``max_len`` steps)."""
    b = memory.shape[0]
    k = beam_width
    dev = memory.device
    state = init_state(memory, k)

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

    for index in range(max_len):
        with profiling.span("beam.wait"):
            ended = bool(end_flag.all())
        if ended:
            break
        with profiling.span("beam.decode", dev):
            top_vals, top_idx, state = step(tokens[:, index], state, index, memory_mask, src, k)
        with profiling.span("beam.select"):
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
            tokens[:, index + 1] = tok.reshape(-1)
            # positions <= index inherit the parent's lineage; index+1 is
            # written by each row itself next iteration
            src = torch.gather(src, 1, parent[:, :, None].expand(b, k, max_len + 1))
            src[:, :, index + 1] = ident
            if reorder is not None:
                state = reorder(state, flat_parent)
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
    step: Callable,
    init_state: Callable,
    memory: torch.Tensor,
    memory_mask: torch.Tensor,
    max_len: int,
    eos_id: int = EOS,
) -> BeamHypotheses:
    """Argmax decoding (beam 1): ``beam_search``'s ``step`` at k = 1 with no
    ancestry map, whose top-1 keeps argmax's smallest-id tie rule."""
    b = memory.shape[0]
    dev = memory.device
    state = init_state(memory, 1)
    tokens = torch.full((b, max_len + 1), eos_id, dtype=torch.long, device=dev)
    tokens[:, 0] = BOS
    scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    end_flag = torch.zeros((b,), dtype=torch.bool, device=dev)
    for index in range(max_len):
        if bool(end_flag.all()):
            break
        vals, idx, state = step(tokens[:, index], state, index, memory_mask, None, 1)
        tok = torch.where(end_flag, eos_id, idx[:, 0].long())
        scores = scores + torch.where(end_flag, 0.0, vals[:, 0])
        tokens[:, index + 1] = tok
        end_flag = end_flag | (tok == eos_id)
    lengths = _lengths(tokens, eos_id, max_len)
    return BeamHypotheses(tokens=tokens[:, None], scores=scores[:, None],
                          lengths=lengths[:, None])
