"""Pipeline parallelism over the mesh's ``pipe`` axis (counterpart of
``opentransformer_tpu/parallel/pipeline.py``).

  * ``pipeline_apply``: the GPipe forward building block. A stack of layers
    split into S stages (this rank runs its stage's), microbatches flowing
    through the stages by a ring shift every tick; autograd through it
    gives the pipelined backward (all forwards, then all backwards).
  * ``one_f_one_b``: the trainer's 1F1B schedule. At tick t stage s runs
    the forward of microbatch t − s, the last stage the loss head of
    microbatch t − (S−1) the same tick (seeding the backward at once), and
    stage s the backward of microbatch t − 2(S−1) + s, for t in
    [0, n + 2(S−1) − 1). The backward recomputes the stage's forward from a
    stashed stage input, so the stash holds 2S − 1 inputs whatever n is.
    Activations go right and input gradients left between ticks, point to
    point (``batch_isend_irecv``).
  * ``Speech2Text1F1B``: the speech2text training loss under it (JAX's
    ``speech2text_1f1b_grad_fn``): the frontend and the positional encoding
    before the schedule on stage 0, this stage's encoder blocks inside it,
    the encoder's final norm, the decoder and the loss (the hybrid CTC loss
    included) as the head on the last stage. The loss is the **mean over
    (microbatch, data shard)** of each one's token-normalized loss, plus
    ``moe_aux_weight`` times the mean over them of the stages' summed MoE
    aux: the reference's DataParallel rule, not the global-batch rule of
    the other modes. Dropout and router jitter draw from a generator
    re-seeded per (data shard, stage, microbatch, layer), so the recompute
    sees the forward's masks.

Tensor and expert parallelism inside a stage are the modules' own
(``parallel/tensor.py``): the stage runs the encoder's sharded blocks, so
JAX's ``tp_blocks_layout`` / ``make_tp_stage_fwd`` re-layout has no
counterpart here. JAX's refusals are kept: ctc and transducer models (no
pipeline loss head), an encoder other than a ``scan_layers`` transformer,
and a pipe that does not divide ``n_blocks``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..data import PAD
from ..models.encoder import encoder_attn_mask
from ..models.modules import rel_pos_embedding
from ..ops.collectives import group_size, reduce_from
from ..ops.loss import label_smoothing_loss
from ..ops.masks import mask_to_length
from .mesh import Mesh


def _neighbours(group):
    """(global rank of the previous stage or None, of the next or None)."""
    s, n = dist.get_rank(group), dist.get_world_size(group)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n - 1 else None
    return prev, nxt


def exchange(send_next, send_prev, recv_shape, dtype, device, group):
    """One tick's point-to-point hand-over: ``send_next`` to the next stage
    and ``send_prev`` to the previous one; returns (from the previous stage,
    from the next stage), None at the ends."""
    if group_size(group) == 1:
        return None, None
    if dist.get_backend(group) == "gloo" and torch.device(device).type != "cpu":
        raise RuntimeError("point-to-point sends on Gloo carry CPU tensors only; a pipeline "
                           "on CUDA tensors needs NCCL")
    prev, nxt = _neighbours(group)
    ops, from_prev, from_next = [], None, None
    if prev is not None:
        from_prev = torch.empty(recv_shape, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, from_prev, prev, group))
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, send_prev.contiguous(), prev, group))
    if nxt is not None:
        ops.append(dist.P2POp(dist.isend, send_next.contiguous(), nxt, group))
        if send_prev is not None:
            from_next = torch.empty(recv_shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, from_next, nxt, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _ShiftRight(torch.autograd.Function):
    """Stage s receives stage s−1's tensor (zeros at stage 0); the backward
    sends the gradient the other way (JAX's ppermute and its transpose)."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        got, _ = exchange(y, None, y.shape, y.dtype, y.device, group)
        return torch.zeros_like(y) if got is None else got

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        prev, nxt = _neighbours(group)
        ops, out = [], torch.zeros_like(g)
        if prev is not None:
            ops.append(dist.P2POp(dist.isend, g.contiguous(), prev, group))
        if nxt is not None:
            ops.append(dist.P2POp(dist.irecv, out, nxt, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out, None


def pipeline_apply(stage_fn, xs: torch.Tensor, mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """Run the stages over microbatches xs [n, mb, ...] (the same on every
    rank of the axis): ``stage_fn`` applies this rank's stage. Returns the
    [n, mb, ...] outputs on every rank of the axis (the last stage's, summed
    out with g)."""
    group = mesh.group(axis)
    n_stages, stage = mesh.size(axis), mesh.index(axis)
    n = xs.shape[0]
    state = torch.zeros_like(xs[0])
    outs = [None] * n
    # every shift's output joins the result with weight 0, so each rank's
    # backward runs all its shifts (in tick order, as its neighbours do)
    link = xs.new_zeros(())
    for t in range(n + n_stages - 1):
        x_in = xs[min(t, n - 1)] if stage == 0 else state
        y = stage_fn(x_in)
        m = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= m < n:
            outs[m] = y
        if group is not None:
            state = _ShiftRight.apply(y, group)
            link = link + state.sum() * 0.0
    out = torch.stack([o if o is not None else torch.zeros_like(xs[0]) for o in outs])
    keep = 1.0 if stage == n_stages - 1 else 0.0
    return reduce_from(out * keep + link, group)


def one_f_one_b(stage_fwd, head_fn, x0s, n_micro: int, act_shape, dtype, device,
                group, scale: float, aux_weight: float | None = None):
    """The 1F1B schedule on this stage. ``stage_fwd(x, m)`` → y, or (y, aux)
    with ``aux_weight``; ``head_fn(y, m)`` → the loss of microbatch m (last
    stage). ``x0s`` are stage 0's inputs (detached here). Gradients of the
    stage's and the head's parameters accumulate into ``.grad`` scaled by
    ``scale``; the MoE aux's cotangent is ``aux_weight``·``scale``.
    Returns (Σ head losses, Σ aux, [dL/dx0 of each microbatch] on stage 0)."""
    s = 0 if group is None else dist.get_rank(group)
    n_stages = group_size(group)
    d_stash = 2 * n_stages - 1
    stash = [None] * d_stash
    has_aux = aux_weight is not None
    zeros = torch.zeros(act_shape, dtype=dtype, device=device)
    act_in = grad_in = None
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=device)
    dx0 = [None] * n_micro
    for t in range(n_micro + 2 * n_stages - 2):
        # forward of microbatch t − s
        mf = t - s
        y = zeros
        if 0 <= mf < n_micro:
            x_in = x0s[mf].detach() if s == 0 else act_in
            stash[mf % d_stash] = x_in
            with torch.no_grad():
                out = stage_fwd(x_in, mf)
            y = out[0] if has_aux else out
            if has_aux:
                aux_acc = aux_acc + out[1].float()
        # the head of the same microbatch on the last stage
        dl_dy = None
        mh = t - (n_stages - 1)
        if s == n_stages - 1 and 0 <= mh < n_micro:
            y_req = y.detach().requires_grad_(True)
            loss_m = head_fn(y_req, mh)
            (loss_m * scale).backward()
            dl_dy = y_req.grad
            loss_acc = loss_acc + loss_m.detach().float()
        # backward of microbatch t − 2(S−1) + s, recomputing the stage
        gx = zeros
        mb = t - 2 * (n_stages - 1) + s
        if 0 <= mb < n_micro:
            x_saved = stash[mb % d_stash].detach().requires_grad_(True)
            out = stage_fwd(x_saved, mb)
            g_in = dl_dy if s == n_stages - 1 else grad_in
            if has_aux:
                aux_g = torch.full_like(out[1], aux_weight * scale)
                torch.autograd.backward([out[0], out[1]], [g_in, aux_g])
            else:
                torch.autograd.backward([out], [g_in])
            gx = x_saved.grad
            if s == 0:
                dx0[mb] = gx
        act_in, grad_in = exchange(y.to(dtype), gx.to(dtype), act_shape, dtype, device, group)
    return loss_acc, aux_acc, dx0


def check_1f1b_model(model, n_stages: int) -> None:
    """JAX's refusals for the 1F1B schedule's model."""
    from ..models.encoder import TransformerEncoder
    from ..models.speech2text import SpeechToText

    if not isinstance(model, SpeechToText):
        raise ValueError(
            f"1F1B pipeline supports speech2text models (got {type(model).__name__}); "
            "ctc/transducer heads are not wired as pipeline loss heads")
    enc = model.encoder
    if not isinstance(enc, TransformerEncoder):
        raise ValueError("1F1B pipeline requires a transformer encoder")
    if not enc.scan_layers:
        raise ValueError("1F1B pipeline requires encoder scan_layers: true")
    if len(enc.layers) % n_stages:
        raise ValueError(f"pipe={n_stages} must divide n_blocks={len(enc.layers)}")


def _seed(base: int, *keys: int) -> int:
    h = base
    for k in keys:
        h = (h * 1000003 + k + 1) % (2 ** 62)
    return h


class Speech2Text1F1B:
    """The speech2text training loss and gradients of one micro-batch under
    1F1B (``one_f_one_b``) on this rank's stage."""

    def __init__(self, model, mesh: Mesh, n_micro: int, generator: torch.Generator,
                 autocast):
        n_stages = mesh.size("pipe")
        check_1f1b_model(model, n_stages)
        self.model, self.mesh, self.n_micro = model, mesh, int(n_micro)
        self.generator, self.autocast = generator, autocast
        self.stage = mesh.index("pipe")
        enc = model.encoder
        per = len(enc.layers) // n_stages
        self.blocks = list(enumerate(enc.layers))[self.stage * per : (self.stage + 1) * per]
        self.moe = enc.moe_experts > 0

    def step(self, feats, feat_mask, targets, targets_length, scale: float):
        """Forward and backward of this rank's rows (n microbatches of the
        data shard), gradients scaled by ``scale``; returns (the local partial
        of the loss, of the MoE aux or None)."""
        model, enc, gen = self.model, self.model.encoder, self.generator
        n, s = self.n_micro, self.stage
        d = self.mesh.index("data")
        base = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=gen.device))
        with self.autocast():
            if s == 0:
                x, mask = model.frontend(feats, feat_mask)
            else:
                with torch.no_grad():
                    x, mask = model.frontend(feats, feat_mask)
            pos_emb = None
            if enc.relative_positional:
                pos_emb = rel_pos_embedding(x.shape[1], enc.d_model, x.dtype, x.device)
            elif s == 0:
                x = enc.pos_enc(x)
        resume = gen.get_state()  # the schedule re-seeds; the stream goes on from here
        mb = x.shape[0] // n
        parts = lambda a: [a[i * mb : (i + 1) * mb] for i in range(n)]  # noqa: E731
        masks = parts(mask)
        attn = [encoder_attn_mask(m, enc.chunk_size, enc.left_chunks) for m in masks]
        tgts, tlens = parts(targets), parts(targets_length)

        def stage_fwd(h, m):
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            with self.autocast():
                for i, block in self.blocks:
                    gen.manual_seed(_seed(base, d, s, m, i))
                    h = block(h, attn[m], pos_emb, masks[m])
                    if isinstance(h, tuple):
                        h, a = h
                        aux = aux + a
            return (h, aux) if self.moe else h

        def head_fn(y, m):
            gen.manual_seed(_seed(base, d, m, 1 << 20))
            with self.autocast():
                memory = enc.after_norm(y) if enc.after_norm is not None else y
                tgt = tgts[m]
                logits = model.decoder(tgt[:, :-1], memory, masks[m])
                loss = label_smoothing_loss(logits, tgt[:, 1:], model.smoothing, pad_id=PAD,
                                            vocab_shard=model.decoder.vocab_shard)
                if model.ctc_weight > 0.0:
                    closs = model.ctc(memory, mask_to_length(masks[m]), tgt[:, 1:], tlens[m])
                    loss = (1.0 - model.ctc_weight) * loss + model.ctc_weight * closs
            return loss

        x0s = parts(x) if s == 0 else None
        loss_acc, aux_acc, dx0 = one_f_one_b(
            stage_fwd, head_fn, x0s, n, (mb,) + tuple(x.shape[1:]), torch.float32, x.device,
            self.mesh.group("pipe"), scale,
            aux_weight=float(model.moe_aux_weight) if self.moe else None)
        gen.set_state(resume)
        if s == 0:
            x.backward(torch.cat(dx0))
        aux = aux_acc * scale if self.moe else None
        loss = loss_acc * scale + (float(model.moe_aux_weight) * aux if self.moe else 0.0)
        return loss, aux
