"""Mesh and sharding rules (counterpart of ``opentransformer_tpu/parallel/mesh.py``).

The JAX package builds a ``Mesh`` of named axes over the devices of one
process and lets GSPMD insert the collectives. Here each card (each CPU rank
in the tests) is one process of a ``torch.distributed`` world, and the mesh
is a ``DeviceMesh`` of four named axes over the ranks, in the order of JAX's
``reshape(dims)`` (row-major: rank = ((d·M + m)·P + p)·E + e):

  * ``data``: the batch's rows split, the gradients summed;
  * ``model``: Megatron tensor parallelism (attention heads, FFN columns,
    the vocabulary rows of a divisible embedding);
  * ``pipe``: pipeline stages over a ``scan_layers`` encoder's blocks;
  * ``expert``: the experts of every MoE layer.

``shape`` is JAX's: ``data`` and ``model`` always, ``pipe`` and ``expert``
only when larger than one. The collectives of a mesh follow its backend:
NCCL for CUDA tensors, Gloo for CPU tensors, chosen by the launcher
(``parallel/launch.py``), never swapped on a failure.

``DEFAULT_RULES`` are JAX's regexes over the flax parameter path, kept as
they are (the port's parameter names map onto those paths mechanically,
``compat.params_to_jax``), and ``param_shardings`` keeps JAX's rule that an
axis absent from the mesh, or one that does not divide the dimension,
replicates that dimension: the 4233-row embedding of every shipped config
stays whole under ``--tp 2`` (4233 = 3·17·83).
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import torch.distributed as dist

AXES = ("data", "model", "pipe", "expert")


class Mesh:
    """This rank's view of a (data, model, pipe, expert) mesh: the process
    group of each axis, its size, and this rank's index along it."""

    def __init__(self, dims: Sequence[int], device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        self.dims = dict(zip(AXES, (int(d) for d in dims)))
        self.device_mesh = init_device_mesh(device_type, tuple(self.dims.values()),
                                            mesh_dim_names=AXES)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        coords = self.device_mesh.get_coordinate()
        self._index = dict(zip(AXES, coords))
        self._groups = {a: self.device_mesh.get_group(a) for a in AXES}

    @property
    def shape(self) -> dict:
        """JAX's ``mesh.shape``: data and model, pipe and expert when > 1."""
        return {a: n for a, n in self.dims.items() if a in ("data", "model") or n > 1}

    def size(self, axis: str) -> int:
        return self.dims[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None when the
        axis has one rank, so callers skip the collective)."""
        return self._groups[axis] if self.dims[axis] > 1 else None

    def __repr__(self) -> str:
        return f"Mesh({self.dims}, rank {self.rank})"


def make_mesh(n_data: int | None = None, n_model: int = 1, n_pipe: int = 1, n_expert: int = 1,
              device_type: str | None = None) -> Mesh:
    """The mesh over the initialized world; ``n_data`` defaults to the world
    size over the other axes' product, which must divide it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world "
                           "(parallel.launch)")
    n = dist.get_world_size()
    if n_data is None:
        if n % (n_model * n_pipe * n_expert):
            raise ValueError(f"{n} ranks do not divide into model {n_model} x pipe {n_pipe} "
                             f"x expert {n_expert}")
        n_data = n // (n_model * n_pipe * n_expert)
    if n_data * n_model * n_pipe * n_expert != n:
        raise ValueError(f"need {n_data}x{n_model}x{n_pipe}x{n_expert} ranks, have {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh((n_data, n_model, n_pipe, n_expert), device_type)


# (regex over 'path/to/param', spec) — first match wins; a spec names, per
# dimension of the flax array (kernels [in, out], embedding [V, D]), the axis
# that shards it or None. Kept as the JAX package has them.
DEFAULT_RULES: tuple[tuple[str, tuple], ...] = (
    (r".*blocks/.*(qkv_proj|q_proj|kv_proj)/dense/kernel$", ("pipe", None, "model")),
    (r".*blocks/.*(ffn|pre_ffn|post_ffn)/w1/dense/kernel$", ("pipe", None, "model")),
    (r".*blocks/.*out_proj/dense/kernel$", ("pipe", "model", None)),
    (r".*blocks/.*(ffn|pre_ffn|post_ffn)/w2/dense/kernel$", ("pipe", "model", None)),
    (r".*blocks/.*pos[uv]$", ("pipe", None, "model", None, None)),
    (r".*blocks/.*moe/w1$", ("pipe", "expert", None, "model")),
    (r".*blocks/.*moe/w2$", ("pipe", "expert", "model", None)),
    (r".*blocks/.*moe/b1$", ("pipe", "expert", "model")),
    (r".*blocks/.*moe/b2$", ("pipe", "expert", None)),
    (r".*blocks/.*", ("pipe",)),
    (r".*moe/w1$", ("expert", None, "model")),
    (r".*moe/w2$", ("expert", "model", None)),
    (r".*moe/b1$", ("expert", "model")),
    (r".*moe/b2$", ("expert", None)),
    (r".*(qkv_proj|q_proj|kv_proj)/dense/kernel$", (None, "model")),
    (r".*(ffn|pre_ffn|post_ffn)/w1/dense/kernel$", (None, "model")),
    (r".*out_proj/dense/kernel$", ("model", None)),
    (r".*(ffn|pre_ffn|post_ffn)/w2/dense/kernel$", ("model", None)),
    (r".*pos_proj/dense/kernel$", (None, "model")),
    (r".*pos[uv]$", (None, "model", None, None)),
    (r".*embedding/embedding$", ("model", None)),
)


def spec_for(path: str, rules: Sequence[tuple[str, tuple]] = DEFAULT_RULES) -> tuple:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return ()


def _flat(tree: Any, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def param_shardings(params: dict, mesh_shape: dict,
                    rules: Sequence[tuple[str, tuple]] = DEFAULT_RULES) -> dict:
    """For each leaf of a flax-layout tree (``compat.params_to_jax``), the
    axis sharding each dimension, or None: ``{'a/b/kernel': (None, 'model')}``.
    An axis absent from ``mesh_shape`` or not dividing the dimension
    replicates that dimension, and a spec longer than the leaf's rank
    replicates the leaf, as in JAX."""
    out = {}
    for path, leaf in _flat(params).items():
        spec = spec_for(path, rules)
        ndim = len(getattr(leaf, "shape", ()))
        if len(spec) > ndim:
            out[path] = (None,) * ndim
            continue
        fixed = []
        for i, axis in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
            size = mesh_shape.get(axis, 1) if axis is not None else 1
            fixed.append(axis if axis in mesh_shape and leaf.shape[i] % size == 0 else None)
        out[path] = tuple(fixed)
    return out


def batch_sharding(batch_rows: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's rows of a global batch sharded over ``axis`` (the whole
    batch, replicated, when the axis does not divide it: a ragged tail)."""
    n = mesh.size(axis)
    if batch_rows % n:
        return slice(0, batch_rows)
    per = batch_rows // n
    return slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)


def replicated(batch_rows: int) -> slice:
    """Every row on every rank."""
    return slice(0, batch_rows)
