"""The trainer's side of a mesh (counterpart of the mesh paths of
``opentransformer_tpu/train/trainer.py``: ``init_state`` with
``param_shardings``, ``_shard_batch``, the gradient all-reduce XLA inserts,
and the pipe axis' stage sharding).

Under GSPMD a mesh step equals one device's step on the global batch, and
``ParallelModel`` keeps that:

  * **data**: each rank takes its contiguous rows of the globally padded
    batch (never re-padded, so MoE capacity and the frames stay the global
    batch's) and runs the forward inside ``loss_context``, which sets the
    data group on the modules that reduce over the batch (the models'
    losses, the MoE layers' aux, BatchNorm's moments;
    ``ops/collectives.py``): each loss is this rank's partial of the global
    batch's, so the data group's gradients are summed, not averaged. A
    batch that the data axis does not divide (a ragged tail) runs whole on
    every rank, as JAX replicates it, with its loss divided by the group
    size so the sum stays one device's.
  * **model / expert**: the modules are sharded in place
    (``parallel/tensor.py``); their forward does the collectives.
  * **pipe**: pipe rank s owns the blocks [s·L/S, (s+1)·L/S) of each
    ``scan_layers`` stack (``_PipeBlock``). A block's parameters are views
    into one flat buffer, whose storage only the owner keeps between uses:
    the weights, their gradients and their Adam moments of the other
    blocks are not held at rest. Under the ``sharded`` schedule (JAX's
    default) every pipe rank runs every block on the same rows (the batch
    shards over ``data`` only): a hook broadcasts the block's weights from
    its owner before its forward and again before its backward, and frees
    them after each. A non-owner's copies of the weights do not require
    gradients, so only the owner computes a block's gradient (the one
    every pipe rank would compute), and only its optimizer steps it. The
    numbers are one device's. Under ``1f1b`` a stage runs its own blocks
    alone (``stage_only``; ``parallel/pipeline.py``), and the hooks fetch
    blocks only outside the schedule (the dev loss, ``gather_state``).

Under ``--multihost`` a data rank's loader reads only its shard of each
batch (``data/loader.py``), and ``assemble`` makes the shard this rank's
rows of the global batch (or, for a batch the shards split unevenly, the
global batch gathered whole): the step is then the one above.

The global gradient norm weighs each local gradient by one over the number
of ranks holding that same tensor, summed over the world. ``gather_state``
and ``gather_optimizer_state`` rebuild the one-card layout (a checkpoint
written by rank 0 is today's format), and ``load_state`` /
``load_optimizer_state`` slice it back (``-ct``, ``-im``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..ops.collectives import all_reduce_, group_size
from .mesh import Mesh, batch_sharding
from .tensor import shard_model


def _pipe_stacks(model: nn.Module, schedule: str) -> list[tuple[str, nn.Module]]:
    """The ``scan_layers`` block stacks the pipe axis shards: the encoder's,
    and under the ``sharded`` schedule a ``scan_layers`` decoder's (JAX's
    ``blocks/`` rule matches both)."""
    out = []
    for name in ("encoder", "decoder"):
        stack = getattr(model, name, None)
        if stack is not None and getattr(stack, "scan_layers", False):
            if name == "decoder" and schedule == "1f1b":
                continue  # the 1F1B head is replicated over the pipe
            out.append((name, stack))
    return out


class _PipeBlock:
    """A pipe-sharded block: its parameters (one dtype) are views into one
    flat buffer, whose storage a non-owner allocates only while the block
    runs (``alloc`` / ``release``)."""

    def __init__(self, module: nn.Module, prefix: str, owner: int, mine: bool):
        named = list(module.named_parameters())
        self.names = [f"{prefix}.{n}" for n, _ in named]
        self.params = [p for _, p in named]
        self.owner, self.mine = owner, mine
        if len({p.dtype for p in self.params}) != 1:
            raise ValueError(f"{prefix}: a pipe-sharded block needs parameters of one dtype")
        p0 = self.params[0]
        self.flat = torch.empty(sum(p.numel() for p in self.params), dtype=p0.dtype,
                                device=p0.device)
        off = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                self.flat[off : off + k].copy_(p.reshape(-1))
                p.data = self.flat[off : off + k].view_as(p)
                off += k
        self.nbytes = self.flat.untyped_storage().nbytes()
        self.live = True
        if not mine:
            for p in self.params:
                p.requires_grad_(False)  # the owner alone computes the gradient
            self.release()

    def alloc(self) -> None:
        if not self.live:
            self.flat.untyped_storage().resize_(self.nbytes)
            self.live = True

    def release(self) -> None:
        if not self.mine and self.live:
            self.flat.untyped_storage().resize_(0)
            self.live = False


class _OnBackward(torch.autograd.Function):
    """Identity on tensors; ``fn`` runs once in the backward, when all
    their gradients have arrived: on a block's outputs before the block's
    backward (fetch its weights), on its inputs after it (release them)."""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.fn = fn
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.fn()
        return (None, *gs)


def _on_backward(values, fn):
    """``values`` (a tensor or a tuple) with the tensors that require
    gradients passed through ``_OnBackward``."""
    single = isinstance(values, torch.Tensor)
    vals = [values] if single else list(values)
    idx = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor) and v.requires_grad]
    if not idx:
        return values
    for i, v in zip(idx, _OnBackward.apply(fn, *(vals[i] for i in idx))):
        vals[i] = v
    return vals[0] if single else tuple(vals)


class ParallelModel:
    """A model sharded over a mesh, with the collectives of its update."""

    def __init__(self, model: nn.Module, mesh: Mesh, schedule: str = "sharded"):
        self.model, self.mesh, self.schedule = model, mesh, schedule
        self.plan = shard_model(model, mesh)
        self.n_pipe = mesh.size("pipe")
        self.pipe_index = mesh.index("pipe")
        self.data_group = mesh.group("data")
        self.pipe_group = mesh.group("pipe")
        # the modules whose reductions over the batch take a data group
        self.loss_modules = [m for m in model.modules() if hasattr(type(m), "data_group")]
        # block parameter name -> the pipe index that owns it; the blocks in
        # forward order
        self.owner: dict[str, int] = {}
        self.blocks: list[_PipeBlock] = []
        self.fetching = True  # off while a 1F1B stage runs its own blocks
        if self.n_pipe > 1:
            for prefix, stack in _pipe_stacks(model, schedule):
                n = len(stack.layers)
                if n % self.n_pipe:
                    if prefix == "encoder":
                        raise ValueError(f"pipe={self.n_pipe} must divide n_blocks={n}")
                    continue  # JAX's rule replicates a dimension that does not divide
                per = n // self.n_pipe
                for i, layer in enumerate(stack.layers):
                    blk = _PipeBlock(layer, f"{prefix}.block_{i}", i // per,
                                     i // per == self.pipe_index)
                    self.owner.update({name: blk.owner for name in blk.names})
                    self.blocks.append(blk)
                    layer.register_forward_pre_hook(self._before_block(blk))
                    layer.register_forward_hook(self._after_block(blk))

    # -------------------------------------------------------------- layout
    @property
    def sharded(self) -> bool:
        """Whether a rank lacks part of the one-card model."""
        return bool(self.plan.specs or self.owner)

    def is_local(self, name: str) -> bool:
        return self.owner.get(name, self.pipe_index) == self.pipe_index

    def local_named_params(self):
        return [(n, p) for n, p in self.model.named_parameters() if self.is_local(n)]

    def copies(self, name: str) -> int:
        """How many ranks hold this rank's tensor of parameter ``name``."""
        shards = self.plan.shard_count(name) * (self.n_pipe if name in self.owner else 1)
        return self.mesh.world // shards

    # ---------------------------------------------------------- pipe blocks
    def _from_owner(self, blk: _PipeBlock, flat: torch.Tensor) -> None:
        """``flat`` (a block-sized buffer) takes its owner's values."""
        src = dist.get_global_rank(self.pipe_group, blk.owner)
        dist.broadcast(flat, src=src, group=self.pipe_group)

    def _fetch(self, blk: _PipeBlock) -> None:
        """The block's weights from its owner to its pipe group (every pipe
        rank takes part, in the same order)."""
        blk.alloc()
        self._from_owner(blk, blk.flat)

    def _before_block(self, blk: _PipeBlock):
        def hook(module, args):
            if not self.fetching:
                return None
            self._fetch(blk)
            if blk.mine or not torch.is_grad_enabled():
                return None
            # once the gradients of all its inputs are out, no node of the
            # block is left to read its weights
            return _on_backward(tuple(args), blk.release)
        return hook

    def _after_block(self, blk: _PipeBlock):
        def hook(module, args, out):
            if not self.fetching:
                return None
            blk.release()
            if not torch.is_grad_enabled():
                return None
            return _on_backward(out, lambda: self._fetch(blk))
        return hook

    def release_blocks(self) -> None:
        for blk in self.blocks:
            blk.release()

    @contextlib.contextmanager
    def stage_only(self):
        """Within the block, blocks run on the weights this rank holds (a
        1F1B stage's own), with no fetch."""
        prev, self.fetching = self.fetching, False
        try:
            yield
        finally:
            self.fetching = prev

    # ---------------------------------------------------------------- data
    def rows(self, n_rows: int, n_micro: int = 0):
        """(this rank's row indices of a global batch, whether it runs whole).
        With ``n_micro`` (1F1B) microbatch m's rows of data shard d are
        m·mb + d·mb/dp + j, JAX's [n, B/n] reshape with the batch dimension
        sharded."""
        dp, d = self.mesh.size("data"), self.mesh.index("data")
        if n_micro:
            mb = n_rows // n_micro
            per = mb // dp
            idx = [m * mb + d * per + j for m in range(n_micro) for j in range(per)]
            return idx, False
        rows = batch_sharding(n_rows, self.mesh)
        return list(range(rows.start, rows.stop)), dp > 1 and n_rows % dp != 0

    def assemble(self, batch, whole: bool = False):
        """A data shard's batch (``FeatureLoader(num_shards=`` the data
        size, ``shard_id=`` this rank's data index ``)``, under
        ``--multihost``) → (batch, local). The global batch is the
        host-major concatenation of the shards, as JAX's multihost trainer
        assembles it, with each array padded to the largest of its shards
        (per dimension), which is what one collate of the global batch pads
        it to. ``local`` is True when every shard holds as many rows and
        ``whole`` is False: the returned batch is then this rank's rows of
        the global batch, padded, and is not sliced again. Otherwise (a
        ragged batch, which JAX's hosts would shape differently, or a caller
        that needs the whole batch) the global batch itself is returned,
        gathered from the shards. ``whole`` must be alike on the ranks whose
        shards hold as many rows."""
        utts, inputs, targets = batch
        keys = [("i", k) for k in sorted(inputs) if getattr(inputs[k], "ndim", 0) > 0]
        keys += [("t", k) for k in sorted(targets) if getattr(targets[k], "ndim", 0) > 0]
        parts = {"i": inputs, "t": targets}
        desc = [len(targets["targets"])] + [tuple(parts[p][k].shape) for p, k in keys]
        descs = [None] * group_size(self.data_group)
        dist.all_gather_object(descs, desc, group=self.data_group)
        padded = {"i": dict(inputs), "t": dict(targets)}
        for j, (p, k) in enumerate(keys, start=1):
            x = parts[p][k]
            top = [max(d[j][a] for d in descs) for a in range(1, x.ndim)]
            widths = [(0, 0)] + [(0, t - n) for t, n in zip(top, x.shape[1:])]
            if any(w for _, w in widths):
                padded[p][k] = np.pad(x, widths)  # zeros: PAD, False, silence
        mine = (utts, padded["i"], padded["t"])
        if not whole and len({d[0] for d in descs}) == 1:
            return mine, True
        shards = [None] * len(descs)
        dist.all_gather_object(shards, mine, group=self.data_group)
        return concat_batches(shards), False

    @contextlib.contextmanager
    def loss_context(self, ragged: bool):
        """Within the block, the losses, the MoE aux and BatchNorm's moments
        are this rank's partials of the data group's batch (a ragged batch,
        which every data rank runs whole, is not split)."""
        group = None if ragged else self.data_group
        for m in self.loss_modules:
            m.data_group = group
        try:
            yield
        finally:
            for m in self.loss_modules:
                m.data_group = None

    # ------------------------------------------------------------ gradients
    def sync_grads(self, optimizer=None) -> list[torch.Tensor]:
        """Sum the local gradients over the data group (under 1F1B the
        head's and the frontend's also over the pipe, whose other ranks hold
        zeros); returns them (a zero one for a local parameter without any).
        A block this rank does not own has none."""
        self.release_blocks()  # a block whose inputs took no gradient
        grads, over_pipe = [], []
        for name, p in self.model.named_parameters():
            if not self.is_local(name):
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
            if self.schedule == "1f1b" and name not in self.owner:
                over_pipe.append(p.grad)
        flat_owner = getattr(optimizer, "grad", None)  # FusedAdam's one buffer
        if flat_owner is not None:
            all_reduce_(flat_owner, self.data_group)
        else:
            _coalesced_all_reduce(grads, self.data_group)
        _coalesced_all_reduce(over_pipe, self.pipe_group)
        return grads

    def grad_norm(self) -> torch.Tensor:
        """The one-card global norm of the synced gradients."""
        sq = None
        for name, p in self.local_named_params():
            s = torch.sum(torch.square(p.grad.float())) / self.copies(name)
            sq = s if sq is None else sq + s
        return torch.sqrt(all_reduce_(sq, dist.group.WORLD if self.mesh.world > 1 else None))

    @torch.no_grad()
    def noise_draws(self, generator: torch.Generator) -> list:
        """(gradient, this rank's slice of its N(0, 1) noise) of each local
        parameter: the noise drawn parameter by parameter in the one-card
        order and shapes from ``generator``, which every rank holds alike,
        as one device draws it."""
        out = []
        for name, p in self.model.named_parameters():
            noise = torch.randn(self.plan.full_shape(name, p.shape), generator=generator,
                                device=p.device, dtype=p.dtype)
            if self.is_local(name):
                out.append((p.grad, self.plan.shard(name, noise)))
        return out

    def report(self, values: torch.Tensor) -> torch.Tensor:
        """Partial losses summed to the step's (over data; under 1F1B also
        over the pipe, where the last stage holds the head's)."""
        all_reduce_(values, self.data_group)
        if self.schedule == "1f1b":
            all_reduce_(values, self.pipe_group)
        return values

    # ----------------------------------------------------- one-card layout
    @torch.no_grad()
    def _block_values(self, value) -> dict:
        """{name: ``value(p)``} of every block parameter, from its owner
        (every pipe rank takes part; a non-owner's are fresh tensors)."""
        out = {}
        for blk in self.blocks:
            if blk.mine:
                vals = [value(p) for p in blk.params]
                flat = torch.cat([v.reshape(-1) for v in vals])
            else:
                flat = torch.empty(blk.flat.numel(), dtype=blk.flat.dtype,
                                   device=blk.flat.device)
            self._from_owner(blk, flat)
            off = 0
            for name, p in zip(blk.names, blk.params):
                out[name] = flat[off : off + p.numel()].view(p.shape)
                off += p.numel()
        return out

    def _one_card(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.plan.gather(name, t) if name in self.plan.specs else t

    @torch.no_grad()
    def gather_grads(self) -> dict:
        """The synced gradients in the one-card layout, by parameter name
        (every rank takes part; a block's from its owner)."""
        blocks = self._block_values(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p))
        return {n: self._one_card(n, blocks.get(n, p.grad if p.grad is not None
                                                 else torch.zeros_like(p)))
                for n, p in self.model.named_parameters()}

    @torch.no_grad()
    def gather_state(self) -> dict:
        """The one-card state dict (every rank takes part)."""
        blocks = self._block_values(lambda p: p)
        return {n: self._one_card(n, blocks.get(n, t))
                for n, t in self.model.state_dict().items()}

    @torch.no_grad()
    def load_state(self, full: dict) -> None:
        """Load a one-card state dict, each rank keeping its slices (of a
        block it does not own, none)."""
        for blk in self.blocks:
            blk.alloc()
        self.model.load_state_dict(
            {n: self.plan.shard(n, t) if n in self.plan.specs else t for n, t in full.items()})
        self.release_blocks()

    @torch.no_grad()
    def gather_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state dict in the one-card layout: sliced moments
        gathered, a block's state from its owner."""
        sd = optimizer.state_dict()
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        state = {}
        for i, name in enumerate(names):
            st = sd["state"].get(i)
            if name in self.owner:
                st = self._state_from_owner(st, params[name], self.owner[name])
            if st is None:
                continue
            state[i] = {k: (self.plan.gather(name, v) if name in self.plan.specs
                            and isinstance(v, torch.Tensor) and v.shape == params[name].shape
                            else v) for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def _state_from_owner(self, st, p: torch.Tensor, owner: int):
        """A block parameter's optimizer state, broadcast from its owner
        (None if the owner has none yet)."""
        dev = p.device
        src, group = dist.get_global_rank(self.pipe_group, owner), self.pipe_group
        mine = self.pipe_index == owner
        layout = [None if not mine or st is None else
                  {k: (("t", tuple(v.shape), v.dtype, v.device.type)
                       if isinstance(v, torch.Tensor) else ("s", v)) for k, v in st.items()}]
        obj_dev = dev if dist.get_backend(group) == "nccl" else None
        dist.broadcast_object_list(layout, src=src, group=group, device=obj_dev)
        if layout[0] is None:
            return None
        out = {}
        for k, desc in layout[0].items():
            if desc[0] == "s":
                out[k] = desc[1]
                continue
            t = st[k].to(dev) if mine else torch.empty(desc[1], dtype=desc[2], device=dev)
            dist.broadcast(t, src=src, group=group)
            out[k] = t.to(desc[3])
        return out

    def load_optimizer_state(self, optimizer, full: dict) -> None:
        """Load a one-card optimizer state dict: each rank keeps its slices
        of the parameters it steps."""
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        state = {}
        for i, st in full["state"].items():
            name = names[int(i)]
            if not self.is_local(name):
                continue
            state[int(i)] = {k: (self.plan.shard(name, v) if name in self.plan.specs
                                 and isinstance(v, torch.Tensor) and v.dim() > 0
                                 and v.shape != params[name].shape else v)
                             for k, v in st.items()}
        optimizer.load_state_dict({"state": state, "param_groups": full["param_groups"]})


def concat_batches(batches: list):
    """Host batches of one shape but the rows → one batch, rows in order
    (a 0-d array is taken from the first)."""
    utts = None if batches[0][0] is None else [u for b in batches for u in b[0]]

    def cat(part: int) -> dict:
        first = batches[0][part]
        return {k: (np.concatenate([b[part][k] for b in batches])
                    if getattr(v, "ndim", 0) > 0 else v) for k, v in first.items()}

    return utts, cat(1), cat(2)


def _coalesced_all_reduce(tensors: list, group) -> None:
    """Sum ``tensors`` over ``group`` in one all-reduce per dtype."""
    if group_size(group) == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()
