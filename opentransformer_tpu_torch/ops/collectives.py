"""Collectives with gradients (the f and g operators of
``opentransformer_tpu/parallel/pipeline.py:132-175``) and the sums of a
data-parallel loss, over process groups that the caller passes.

They sit at the ops layer so that the models and the losses can take a
group without importing ``parallel/``; which group a module uses is set on
it by ``parallel/`` (``tensor.shard_model``, ``engine.ParallelModel``), and
every function here is the plain single-device arithmetic for ``group=None``
or a group of one rank.

Only two collectives carry tensors here, ``all_reduce`` (sum) and
``broadcast``, plus point-to-point sends in the 1F1B schedule: a gather is an
all-reduce of a zero-padded tensor. Gloo carries exactly these two for CUDA
tensors, so every mode but 1F1B runs on any backend.

The operators, for a group of ranks that hold the same replicated tensor:

  * ``copy_to(x, group)`` is Megatron's "f": identity forward, all-reduce
    backward. It sits at the input of a branch that is split over the group
    (heads, FFN columns, vocabulary rows, experts), so the partial input
    gradients of the shards sum to the whole one.
  * ``reduce_from(x, group)`` is Megatron's "g": all-reduce forward, identity
    backward. It closes a split branch. It must be explicit rather than an
    all-reduce whose backward all-reduces again: the cotangent arriving from
    the replicated tensors downstream is the same on every rank, and a
    second all-reduce would count the branch gradients once per rank.

A data group is the other half: its ranks hold different rows, so a loss
is a *partial*, and the partials of the group sum to the global batch's
loss. ``global_mean`` divides a local sum by the group's summed count, and
``sum_over`` sums a statistic with a gradient (BatchNorm's moments),
all-reducing forward and backward because every rank's partial loss
depends on the sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class VocabShard(NamedTuple):
    """This rank's columns [start, start + V/n) of a vocabulary of ``size``
    split over ``group`` (tensor parallelism)."""

    group: object
    start: int
    size: int


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (a no-op for one rank)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of equal shape concatenated along ``dim`` in rank
    order, by an all-reduce of this rank's shard placed in zeros (no
    gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    size = shape[dim]
    shape[dim] = size * n
    full = x.new_zeros(shape)
    full.narrow(dim, group_rank(group) * size, size).copy_(x)
    return all_reduce_(full, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce backward."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


# ------------------------------------------------------ data-parallel sums
def count_over(count, group, device=None) -> torch.Tensor:
    """A count (no gradient) as float32 on ``device`` (a tensor's own by
    default), summed over ``group``."""
    if device is None and isinstance(count, torch.Tensor):
        device = count.device
    c = torch.as_tensor(count, dtype=torch.float32, device=device).detach().clone()
    return all_reduce_(c, group)


def global_mean(total: torch.Tensor, count, group) -> torch.Tensor:
    """``total / max(count, 1)`` with ``count`` summed over ``group``: this
    rank's partial of the group's mean."""
    return total / torch.clamp_min(count_over(count, group, total.device), 1.0)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """A statistic with a gradient summed over ``group`` (forward and
    backward all-reduce); itself for one rank."""
    return x if group_size(group) == 1 else _SumOver.apply(x, group)


def batch_mean(per_row: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the batch's rows (this rank's partial of the mean over
    ``group``'s rows)."""
    if group_size(group) == 1:
        return per_row.mean()
    return global_mean(per_row.sum(), per_row.shape[0], group)


# ------------------------------------------------------ a split vocabulary
def vocab_parallel_logits(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                          shard: VocabShard) -> torch.Tensor:
    """This rank's columns f32[..., V/n] of tied logits over its rows
    ``weight`` [V/n, D] of the table (f at the input; the whole bias through
    f, so each rank's slice of its gradient sums to the whole one)."""
    local = copy_to(h, shard.group).float() @ weight.to(h.dtype).float().T
    if bias is None:
        return local
    bias = copy_to(bias, shard.group).float()
    return local + bias[shard.start : shard.start + weight.shape[0]]
