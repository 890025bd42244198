"""RNN-Transducer, inference side (counterpart of
``opentransformer_tpu/models/transducer.py``).

  * ``TransducerPredictionNetwork``: embedding → LSTM stack (the flax
    ``OptimizedLSTMCell`` layout of ``lm.LSTMCell``, carry (c, h)), over a
    label sequence or one label a step.
  * ``TransducerJointNetwork``: ``tanh(enc_proj(enc) + pred_proj(pred))`` →
    vocabulary projection; ``step_argmax`` takes a lattice step's argmax
    through the fused projection → log-softmax → top-k (kernel 1 at k = 1
    on the card), so the [B, V] logits are never written.
  * ``TransducerModel``: frontend → encoder → prediction and joint
    networks; the training loss (``forward``: the RNN-T loss of
    ``ops/rnnt_loss.py`` over the full joint, or over the blank and label
    slices of T-blocks of it, ``blank_emit_log_probs``), the
    frame-synchronous greedy decode (``greedy_frames``, resumable across
    chunks for streaming) and the time-synchronous mAES beam with optional
    LM shallow fusion (``beam_decode``).

Blank = PAD = 0. The greedy lattice loop checks on the host, once an
iteration, whether any row still has frames; ``greedy_iterations`` counts
the iterations, each of which launches kernel 1 once.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data import BLK, BOS
from ..ops.collectives import batch_mean
from ..ops.masks import mask_to_length
from ..ops.project_topk import project_logp_topk, topk_smallest_id
from ..ops.rnnt_loss import rnnt_loss_from_blank_emit, rnnt_loss_mean
from .lm import RNN
from .modules import Dropout
from .speech2text import ENCODERS, FRONTENDS, _build, add_moe_aux, encode_with

NEG = -1.0e30


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested lists, tuples and dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


class TransducerPredictionNetwork(nn.Module):
    """Label-history encoder: embedding → ``num_layers`` LSTMs, with
    ``dropout`` between them in training."""

    def __init__(self, vocab_size: int, d_model: int = 256, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.embedding = nn.Embedding(vocab_size, d_model)
        self.rnns = []
        for i in range(num_layers):
            rnn = RNN(d_model, d_model)
            self.add_module(f"lstm_{i}", rnn)
            self.rnns.append(rnn)
        self.drop = Dropout(dropout)

    def init_hidden(self, batch: int):
        """Per-layer (c, h) of [batch, d_model] zeros."""
        p = self.embedding.weight
        return [(torch.zeros((batch, self.d_model), dtype=p.dtype, device=p.device),
                 torch.zeros((batch, self.d_model), dtype=p.dtype, device=p.device))
                for _ in range(self.num_layers)]

    def forward(self, tokens):
        """tokens int[B, U1] (BOS ⧺ labels) → states [B, U1, D]."""
        x = self.embedding(tokens)
        for i, (rnn, carry) in enumerate(zip(self.rnns, self.init_hidden(tokens.shape[0]))):
            _, x = rnn(x, carry)
            if i + 1 < self.num_layers:
                x = self.drop(x)
        return x

    def decode_step(self, token_t, hidden):
        """token_t int[B] → (state [B, D], new hidden)."""
        x = self.embedding(token_t)
        new_hidden = []
        for rnn, carry in zip(self.rnns, hidden):
            carry, x = rnn.cell(carry, x)
            new_hidden.append(carry)
        return x, new_hidden


class TransducerJointNetwork(nn.Module):
    """The additive joiner: enc-proj + pred-proj → tanh → vocabulary."""

    def __init__(self, enc_dim: int, pred_dim: int, vocab_size: int, d_joint: int = 256):
        super().__init__()
        self.enc_proj = nn.Linear(enc_dim, d_joint)
        self.pred_proj = nn.Linear(pred_dim, d_joint)
        self.output_layer = nn.Linear(d_joint, vocab_size)

    def forward(self, enc, pred):
        """enc [B, T, De], pred [B, U1, Dp] → logits f32[B, T, U1, V]."""
        h = torch.tanh(self.enc_proj(enc)[:, :, None, :] + self.pred_proj(pred)[:, None, :, :])
        return self.output_layer(h).float()

    def _hidden(self, enc_t, pred_u):
        return torch.tanh(self.enc_proj(enc_t) + self.pred_proj(pred_u))

    def step(self, enc_t, pred_u):
        """enc_t [B, De], pred_u [B, Dp] → logits f32[B, V]."""
        return self.output_layer(self._hidden(enc_t, pred_u)).float()

    def step_argmax(self, enc_t, pred_u):
        """The argmax label of ``step`` (int[B], ties to the smallest id, as
        ``jnp.argmax``) through the fused projection top-1: kernel 1 on a
        CUDA tensor, its plain version on a CPU tensor."""
        h = self._hidden(enc_t, pred_u).contiguous()
        _, idx = project_logp_topk(h, self.output_layer.weight, self.output_layer.bias, 1)
        return idx[:, 0].long()

    def _block_log_probs(self, eh_blk, ph, labels, blank: int):
        h = torch.tanh(eh_blk[:, :, None, :] + ph[:, None, :, :])
        logits = self.output_layer(h).float()  # [B, TB, U1, V]
        lse = torch.logsumexp(logits, dim=-1)
        lp_blank = logits[..., blank] - lse
        emit = torch.gather(logits[:, :, :-1, :], 3, labels[:, None, :, None].expand(
            -1, logits.shape[1], -1, 1))[..., 0] - lse[:, :, :-1]
        return lp_blank, emit

    def blank_emit_log_probs(self, enc, pred, labels, blank: int = 0, t_block: int = 16):
        """The two slices of the joint's log-probs that the RNN-T loss
        reads, T-block by T-block: enc [B, T, De], pred [B, U1, Dp], labels
        int[B, U1 − 1] → (lp_blank f32[B, T, U1], emit f32[B, T, U1 − 1]).
        T is padded to whole blocks of ``t_block``; each block's [B, TB,
        U1, V] logits are reduced to the slices and dropped, and recomputed
        in the backward pass (activation checkpointing), so peak memory is
        O(B·TB·U1·V) both ways."""
        eh = self.enc_proj(enc)
        ph = self.pred_proj(pred)
        t = eh.shape[1]
        t_pad = -(-t // t_block) * t_block
        eh = nn.functional.pad(eh, (0, 0, 0, t_pad - t))
        labels = labels.long()
        parts = [checkpoint(self._block_log_probs, eh[:, s : s + t_block], ph, labels, blank,
                            use_reentrant=False)
                 for s in range(0, t_pad, t_block)]
        return (torch.cat([p[0] for p in parts], dim=1)[:, :t],
                torch.cat([p[1] for p in parts], dim=1)[:, :t])


class TransducerModel(nn.Module):
    """frontend → encoder → prediction and joint networks.
    ``joint_t_block`` picks how the loss evaluates the joint: −1 the full
    joint while its f32 logits take at most 2 GiB, else T-blocks of 32; 0
    the full joint; N > 0 T-blocks of N. ``moe_aux_weight`` weighs an MoE
    encoder's load-balance loss in the training loss. ``data_group`` (set
    by ``parallel/engine.py``) makes the loss this rank's partial of that
    data group's batch mean."""

    data_group = None

    def __init__(self, frontend_cfg: dict, encoder_cfg: dict, vocab_size: int,
                 predictor_cfg: dict | None = None, d_joint: int | None = None,
                 frontend_type: str = "conv", encoder_type: str = "transformer",
                 joint_t_block: int = -1, moe_aux_weight: float = 0.01):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.moe_aux_weight = moe_aux_weight
        self.joint_t_block = int(joint_t_block)
        self.frontend = _build(FRONTENDS[frontend_type], frontend_cfg)
        self.encoder = _build(ENCODERS[encoder_type], encoder_cfg)
        pc = dict(predictor_cfg or {})
        pc.setdefault("d_model", self.encoder.d_model)
        self.predictor = TransducerPredictionNetwork(
            self.vocab_size, **{k: v for k, v in pc.items()
                                if k in ("d_model", "num_layers", "dropout")})
        self.joint = TransducerJointNetwork(
            self.encoder.d_model, self.predictor.d_model, self.vocab_size,
            self.encoder.d_model if d_joint is None else int(d_joint))
        self.greedy_iterations = 0  # lattice-loop iterations, one kernel-1 launch each

    @property
    def dtype(self):
        return self.joint.output_layer.weight.dtype

    def encode(self, feats, feat_mask, return_aux: bool = False):
        """feats [B, T, F], bool[B, T] → (memory [B, T', D], bool[B, T'][,
        the MoE aux])."""
        return encode_with(self, feats, feat_mask, return_aux)

    def forward(self, feats, feat_mask, targets, targets_length):
        """The RNN-T loss: (scalar float32 batch mean, {}), with an MoE
        encoder's ``moe_aux_weight``·``moe_aux`` added. Targets as the
        collate writes them (BOS ⧺ y ⧺ EOS ⧺ PAD…, ``targets_length`` =
        len(y) + 1): the predictor reads ``targets[:, :-1]``, the labels are
        ``targets[:, 1:]`` with ``targets_length − 1`` of them."""
        memory, memory_mask, moe_aux = self.encode(feats, feat_mask, return_aux=True)
        pred_in = targets[:, :-1]
        pred = self.predictor(pred_in)
        frame_len = mask_to_length(memory_mask)
        t_block = self.joint_t_block
        if t_block < 0:
            b, t = memory.shape[0], memory.shape[1]
            t_block = 0 if 4 * b * t * pred_in.shape[1] * self.vocab_size <= (2 << 30) else 32
        if t_block > 0:
            u_max = pred_in.shape[1] - 1
            lp_blank, emit = self.joint.blank_emit_log_probs(
                memory, pred, targets[:, 1 : 1 + u_max], blank=BLK, t_block=t_block)
            loss = batch_mean(rnnt_loss_from_blank_emit(lp_blank, emit, frame_len,
                                                        targets_length - 1), self.data_group)
        else:
            log_probs = torch.log_softmax(self.joint(memory, pred), dim=-1)
            loss = rnnt_loss_mean(log_probs, targets[:, 1:], frame_len, targets_length - 1,
                                  blank=BLK, group=self.data_group)
        return add_moe_aux(loss, {}, moe_aux, self.moe_aux_weight)

    def init_decode_state(self, batch: int):
        """(prediction state [B, D], hidden) primed with BOS: the carry of
        ``greedy_frames`` (offline decode and chunk streaming share it)."""
        dev = self.predictor.embedding.weight.device
        return self.predictor.decode_step(
            torch.full((batch,), BOS, dtype=torch.long, device=dev),
            self.predictor.init_hidden(batch))

    def greedy_frames(self, memory, frame_len, state, hidden, max_symbols: int = 200,
                      max_per_frame: int = 8):
        """Frame-synchronous greedy search over ``memory`` [B, T, D]: at each
        lattice state emit the argmax label and advance the prediction
        network, or consume a frame on blank. Every row runs until its
        ``frame_len`` frames are used; the caps ``max_symbols`` (a row) and
        ``max_per_frame`` force a blank. A row with no frame is never
        stepped.

        Returns (tokens int[B, max_symbols] 0-padded, n int[B], state,
        hidden): the carried (state, hidden) make this resumable chunk by
        chunk."""
        b, t_max, _ = memory.shape
        dev = memory.device
        frame_len = frame_len.to(device=dev, dtype=torch.long)
        rows = torch.arange(b, device=dev)
        slots = torch.arange(max_symbols, device=dev)[None]
        t = torch.zeros(b, dtype=torch.long, device=dev)
        n = torch.zeros(b, dtype=torch.long, device=dev)
        emitted_in_frame = torch.zeros(b, dtype=torch.long, device=dev)
        tokens = torch.zeros((b, max_symbols), dtype=torch.long, device=dev)
        while bool((t < frame_len).any()):
            self.greedy_iterations += 1
            enc_t = memory[rows, t.clamp(max=t_max - 1)]
            best = self.joint.step_argmax(enc_t, state)
            active = t < frame_len
            emit = ((best != BLK) & active & (n < max_symbols)
                    & (emitted_in_frame < max_per_frame))
            new_state, new_hidden = self.predictor.decode_step(best, hidden)
            keep = emit[:, None]
            state = torch.where(keep, new_state, state)
            hidden = [(torch.where(keep, nc, c), torch.where(keep, nh, h))
                      for (nc, nh), (c, h) in zip(new_hidden, hidden)]
            tokens = torch.where(keep & (slots == n[:, None]), best[:, None], tokens)
            n = n + emit.long()
            t = torch.where(active & ~emit, t + 1, t)
            emitted_in_frame = torch.where(emit, emitted_in_frame + 1, 0)
        return tokens, n, state, hidden

    @torch.inference_mode()
    def greedy_decode(self, feats, feat_mask, max_symbols: int = 200, max_per_frame: int = 8):
        """Offline batched greedy search → (tokens int[B, max_symbols]
        0-padded, n_tokens int[B])."""
        memory, memory_mask = self.encode(feats, feat_mask)
        state, hidden = self.init_decode_state(memory.shape[0])
        tokens, n, _, _ = self.greedy_frames(memory, mask_to_length(memory_mask), state, hidden,
                                             max_symbols, max_per_frame)
        return tokens, n

    @torch.inference_mode()
    def beam_decode(self, feats, feat_mask, beam_width: int = 4, max_symbols: int = 100,
                    expansions: int = 2, lm_init=None, lm_step=None, lm_weight: float = 0.0):
        """Time-synchronous transducer beam search with at most
        ``expansions`` label expansions a frame (mAES): every frame, each of
        the K hypotheses is blank-finalized into the next frame's beam and
        extended by its top non-blank labels; the next beam is the top K of
        all finalized candidates, equal label sequences merged by logsumexp
        into the earliest slot. Plain PyTorch: the expansion's top-K over
        K·V candidates needs the materialized log-probs.

        LM shallow fusion through ``lm_init`` / ``lm_step``
        (``recognize/base.make_lm_adapter``): a blank leaves the LM as it
        is; a label adds ``lm_weight · log p_lm(label | prefix)`` and steps
        the LM at the hypothesis' own position (BOS at 0, labels from 1).

        Returns (tokens int[B, K, max_symbols], lengths int[B, K], scores
        f32[B, K]), sorted best first."""
        memory, memory_mask = self.encode(feats, feat_mask)
        b, t_max, _ = memory.shape
        k = beam_width
        dev = memory.device
        frame_len = mask_to_length(memory_mask)
        state0, hidden0 = self.init_decode_state(b)
        bi = torch.arange(b, device=dev)[:, None]

        def tile(x):
            return x[:, None].repeat_interleave(k, dim=1)

        def gather(tree, idx):  # along the beam axis by idx [B, K] (a copy)
            return tree_map(lambda x: x[bi, idx], tree)

        def flat(tree):
            return tree_map(lambda x: x.reshape((b * k,) + x.shape[2:]), tree)

        def unflat(tree):
            return tree_map(lambda x: x.reshape((b, k) + x.shape[1:]), tree)

        use_lm = lm_step is not None and lm_weight != 0.0
        scores0 = torch.full((b, k), NEG, device=dev)
        scores0[:, 0] = 0.0
        beam = {"scores": scores0,
                "tokens": torch.zeros((b, k, max_symbols), dtype=torch.long, device=dev),
                "lens": torch.zeros((b, k), dtype=torch.long, device=dev),
                "state": tile(state0), "hidden": tree_map(tile, hidden0)}
        if use_lm:
            lm_lp0, lm_state0 = lm_step(torch.full((b,), BOS, dtype=torch.long, device=dev),
                                        lm_init(b), 0)
            beam["lm_lp"] = tile(lm_lp0)
            beam["lm_state"] = tree_map(tile, lm_state0)
        slot = torch.arange(2 * k, device=dev)
        earlier = slot[None, :, None] < slot[None, None, :]
        positions = torch.arange(max_symbols, device=dev)[None, None, :]

        def joint_logp(enc_t, beam_state):
            enc_bk = enc_t[:, None].repeat_interleave(k, dim=1).reshape(b * k, -1)
            logits = self.joint.step(enc_bk, beam_state.reshape(b * k, -1))
            return torch.log_softmax(logits, dim=-1).reshape(b, k, -1)

        def rest(tree):
            return {key: val for key, val in tree.items() if key != "scores"}

        for t in range(t_max):
            enc_t = memory[:, t]
            active = beam
            done = dict(beam, scores=torch.full((b, k), NEG, device=dev))
            for e in range(expansions + 1):
                logp = joint_logp(enc_t, active["state"])
                # blank-finalize every active hypothesis into the done set
                blank_scores = active["scores"] + logp[..., BLK]
                cat = tree_map(lambda d, a: torch.cat([d, a], dim=1), rest(done), rest(active))
                cat_scores = torch.cat([done["scores"], blank_scores], dim=1)
                # prefix merge over the 2K union: equal buffers (0-padded past
                # lens) of equal length fold into the earliest slot
                same = ((cat["tokens"][:, :, None, :] == cat["tokens"][:, None, :, :]).all(-1)
                        & (cat["lens"][:, :, None] == cat["lens"][:, None, :]))
                is_dup = (same & earlier).any(dim=1)
                merged = torch.logsumexp(cat_scores[:, None, :].masked_fill(~same, NEG), dim=-1)
                cat_scores = merged.masked_fill(is_dup, NEG)
                top_scores, top = topk_smallest_id(cat_scores, k)
                done = {"scores": top_scores, **gather(cat, top)}
                if e == expansions:
                    break
                # expand: the top K non-blank continuations of K·V candidates
                nb = active["scores"][:, :, None] + logp
                if use_lm:
                    nb = nb + lm_weight * active["lm_lp"]
                nb[..., BLK] = NEG
                nb = nb.masked_fill((active["lens"] >= max_symbols)[:, :, None], NEG)
                v = nb.shape[-1]
                flat_scores, flat_idx = topk_smallest_id(nb.reshape(b, k * v), k)
                parent = torch.div(flat_idx, v, rounding_mode="floor")
                label = flat_idx % v
                new = {"scores": flat_scores, **gather(rest(active), parent)}
                new["tokens"] = torch.where(positions == new["lens"][:, :, None],
                                            label[:, :, None], new["tokens"])
                new["lens"] = new["lens"] + 1
                ns, nh = self.predictor.decode_step(label.reshape(b * k), flat(new["hidden"]))
                new["state"] = ns.reshape(b, k, -1)
                new["hidden"] = unflat(nh)
                if use_lm:
                    # the gathered LM state is this hypothesis' own copy, so an
                    # LM that writes its caches in place touches nothing else
                    lm_lp, lm_state = lm_step(label.reshape(b * k), flat(new["lm_state"]),
                                              new["lens"].reshape(b * k))
                    new["lm_lp"] = lm_lp.reshape(b, k, -1)
                    new["lm_state"] = unflat(lm_state)
                active = new
            # advance only the rows that still have frames
            live = t < frame_len
            beam = tree_map(lambda o, u: torch.where(
                live.reshape((-1,) + (1,) * (o.dim() - 1)), u, o), beam, done)
        order = torch.argsort(-beam["scores"], dim=1, stable=True)
        return (beam["tokens"][bi, order], beam["lens"][bi, order],
                beam["scores"][bi, order])
