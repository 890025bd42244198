"""Tensor and expert parallelism by sharding the model's own modules
(``parallel/mesh.py``'s ``model`` and ``expert`` axes; JAX's
``DEFAULT_RULES``, and the Megatron layout of ``tp_blocks_layout``,
``opentransformer_tpu/parallel/pipeline.py:403-527``).

``shard_model(model, mesh)`` replaces, in place, each parameter that the
rules shard by this rank's slice and makes the module's forward collective:

  * attention (self, cross, rel-pos): the heads split over ``model``. The
    QKV / Q / KV projections are column-parallel (``ColumnParallelLinear``:
    f at the input), the fused Q|K|V (or K|V) columns taken per head group so
    each rank holds matching heads; the rel-pos ``pos_proj`` columns and the
    ``posu`` / ``posv`` biases split with them; ``out_proj`` is row-parallel
    (``RowParallelLinear``: g closes the branch, the bias added once after
    it). The module's ``n_heads`` becomes its local count.
  * FFN (``ffn``, ``pre_ffn``, ``post_ffn``): ``w1`` column-parallel with a
    GLU's two halves matched per shard (its [2F] columns viewed as [2, F],
    F split), ``w2`` row-parallel. A contiguous shard of [2F] would give one
    rank all of ``a`` and another all of ``σ(b)``. The hidden's dropout
    draws the whole width's mask and keeps this rank's columns
    (``Dropout.shard``): the ranks of a group share their generator, and a
    mask drawn at the local width would drop features f and f + F/n
    together.
  * an embedding whose vocabulary ``model`` divides (``VocabParallelEmbedding``):
    a masked lookup of this rank's rows and g; the head that ties its output
    projection to it gets ``vocab_shard`` and keeps this rank's columns of
    the logits (``ops/collectives.py:vocab_parallel_logits``, f before it),
    and the label-smoothing loss takes its log-softmax over the group
    (``ops/loss.py:sharded_smoothing_kl``: a distributed logsumexp). A
    vocabulary that does not divide stays whole, as JAX's rule replicates it.
  * MoE: the experts [E, ...] split over ``expert``, each expert's hidden
    dimension over ``model`` (GLU-matched); the router stays whole. The
    layer's output is the sum of the group's partial combines
    (``MoEFeedForward.shard``).

A dimension that the axis does not divide (heads, d_ff, experts) keeps the
module whole, as JAX's rule replicates a non-dividing dimension.

``ShardPlan`` records, per parameter name, how it was sliced: a list of
``(dim, groups, axis)``, the dimension viewed as [groups, n] and n split
into the axis' contiguous parts. It slices a one-card tensor to this rank's
(``shard``), and gathers this rank's back to the one-card layout
(``gather``, an all-reduce of zero-padded shards), which checkpoints and
the tests use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.modules import (
    MoEFeedForward,
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
    PositionwiseFeedForward,
    RelPosSelfAttention,
)
from ..ops.collectives import VocabShard, copy_to, gather_cat, reduce_from
from .mesh import Mesh


class ColumnParallelLinear(nn.Linear):
    """This rank's output columns: f at the input, then the local product."""

    group = None

    def forward(self, x):
        return F.linear(copy_to(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """This rank's input rows: the local product, g over the group, then the
    (replicated) bias once."""

    group = None

    def forward(self, x):
        y = reduce_from(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """This rank's rows [v0, v0 + V/n) of the table: ids outside them look
    up zeros, and g sums the group's lookups."""

    group = None
    vocab_start = 0

    def forward(self, ids):
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < self.num_embeddings)
        x = F.embedding(local.clamp(0, self.num_embeddings - 1), self.weight)
        return reduce_from(x * inside[..., None].to(x.dtype), self.group)

    vocab_size = 0  # the whole table's rows

    def vocab_shard(self) -> VocabShard:
        return VocabShard(self.group, self.vocab_start, self.vocab_size)


class ShardPlan:
    """How each parameter (state-dict name) of a sharded model was sliced."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.specs: dict[str, list[tuple[int, int, str]]] = {}

    def shard_count(self, name: str) -> int:
        n = 1
        for _, _, axis in self.specs.get(name, ()):
            n *= self.mesh.size(axis)
        return n

    def full_shape(self, name: str, shape) -> tuple:
        """The one-card shape of this rank's ``shape`` of parameter ``name``."""
        shape = list(shape)
        for dim, _, axis in self.specs.get(name, ()):
            shape[dim] *= self.mesh.size(axis)
        return tuple(shape)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a one-card tensor."""
        t = full
        for dim, g, axis in self.specs.get(name, ()):
            n, i = self.mesh.size(axis), self.mesh.index(axis)
            v = t.unflatten(dim, (g, -1))
            t = v.chunk(n, dim + 1)[i].flatten(dim, dim + 1)
        return t.contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The one-card tensor from this rank's slice (every rank of the
        slice's groups takes part)."""
        t = local
        for dim, g, axis in reversed(self.specs.get(name, ())):
            v = t.unflatten(dim, (g, -1))
            t = gather_cat(v.contiguous(), dim + 1, self.mesh.group(axis)).flatten(dim, dim + 1)
        return t

    def add(self, prefix: str, module: nn.Module, pname: str, specs) -> None:
        """Slice ``module.<pname>`` in place by ``specs``."""
        name = f"{prefix}.{pname}" if prefix else pname
        specs = [s for s in specs if self.mesh.size(s[2]) > 1]
        if not specs:
            return
        self.specs[name] = specs
        p = getattr(module, pname)
        setattr(module, pname,
                nn.Parameter(self.shard(name, p.data), requires_grad=p.requires_grad))


def _swap(linear: nn.Linear, cls, group) -> None:
    linear.__class__ = cls
    linear.group = group


def shard_model(model: nn.Module, mesh: Mesh) -> ShardPlan:
    """Shard ``model`` in place over the mesh's ``model`` and ``expert`` axes
    (before the optimizer is built); returns the plan."""
    plan = ShardPlan(mesh)
    tp, gm = mesh.size("model"), mesh.group("model")
    for prefix, mod in list(model.named_modules()):
        def name(child):
            return f"{prefix}.{child}" if prefix else child

        if isinstance(mod, (MultiHeadSelfAttention, RelPosSelfAttention,
                            MultiHeadCrossAttention)) and tp > 1 and mod.n_heads % tp == 0:
            if isinstance(mod, MultiHeadCrossAttention):
                cols = [("q_proj", 1), ("kv_proj", 2)]
            else:
                cols = [("qkv_proj", 1 if getattr(mod, "share_qvk_proj", False) else 3)]
            if isinstance(mod, RelPosSelfAttention):
                if mod.out_proj is None:
                    continue  # ref_compat returns the head concat: kept whole
                cols.append(("pos_proj", 1))
                for pname in ("posu", "posv"):
                    plan.add(prefix, mod, pname, [(1, 1, "model")])
            for child, g in cols:
                lin = getattr(mod, child)
                for pname in ("weight", "bias"):
                    if getattr(lin, pname) is not None:
                        plan.add(name(child), lin, pname, [(0, g, "model")])
                _swap(lin, ColumnParallelLinear, gm)
            plan.add(name("out_proj"), mod.out_proj, "weight", [(1, 1, "model")])
            _swap(mod.out_proj, RowParallelLinear, gm)
            mod.n_heads //= tp
        elif isinstance(mod, PositionwiseFeedForward) and tp > 1:
            if mod.w2.weight.shape[1] % tp:
                continue
            g = 2 if mod.activation == "glu" else 1
            for pname in ("weight", "bias"):
                plan.add(name("w1"), mod.w1, pname, [(0, g, "model")])
            _swap(mod.w1, ColumnParallelLinear, gm)
            plan.add(name("w2"), mod.w2, "weight", [(1, 1, "model")])
            _swap(mod.w2, RowParallelLinear, gm)
            mod.dropout.shard = [(-1, mesh.index("model"), tp)]
        elif isinstance(mod, nn.Embedding) and tp > 1 and mod.num_embeddings % tp == 0:
            plan.add(prefix, mod, "weight", [(0, 1, "model")])
            mod.__class__ = VocabParallelEmbedding
            mod.group = gm
            mod.vocab_size = mod.num_embeddings
            mod.num_embeddings //= tp
            mod.vocab_start = mesh.index("model") * mod.num_embeddings
        elif isinstance(mod, MoEFeedForward):
            ep = mesh.size("expert")
            e_spec = [(0, 1, "expert")] if ep > 1 and mod.n_experts % ep == 0 else []
            d_ff = mod.w2.shape[1]
            m_ok = tp > 1 and d_ff % tp == 0
            g = 2 if mod.activation == "glu" else 1
            plan.add(prefix, mod, "w1", e_spec + ([(2, g, "model")] if m_ok else []))
            plan.add(prefix, mod, "b1", e_spec + ([(1, g, "model")] if m_ok else []))
            plan.add(prefix, mod, "w2", e_spec + ([(1, 1, "model")] if m_ok else []))
            plan.add(prefix, mod, "b2", e_spec)
            groups = []
            if e_spec:
                groups.append(("expert", mesh.index("expert") * (mod.n_experts // ep),
                               mesh.group("expert")))
                mod.dropout.shard.append((0, mesh.index("expert"), ep))
            if m_ok:
                groups.append(("model", mesh.index("model"), gm))
                mod.dropout.shard.append((-1, mesh.index("model"), tp))
            mod.shard = groups
    for mod in model.modules():  # a decoder's or an LM's tied output projection
        if getattr(mod, "share_embedding", False) and \
                isinstance(getattr(mod, "embedding", None), VocabParallelEmbedding):
            mod.vocab_shard = mod.embedding.vocab_shard()
    return plan
