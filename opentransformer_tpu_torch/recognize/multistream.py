"""Batched multi-stream frame-synchronous recognition
(counterpart of ``opentransformer_tpu/recognize/multistream.py``).

Up to N independent streams advance in one fused step a tick: each owns a
row of the batched encoder caches, with per-row stream positions (int[B]
``start`` / ``cache_len``) so that streams at different depths share one
batch. Rows without a pending chunk keep their caches (``torch.where`` on
``advance``); a slot's KV caches are reused without zeroing, because
``cache_len = 0`` masks what its last stream left there. A conformer's
causal-conv state has no such mask, so a fresh row's is zeroed (the JAX
package reuses it as it is, which leaks the last stream's final frames into
the next stream's first chunk).

A tick runs frontend → ``encode_step`` → head on the model's device: the
CTC head's top-1 through kernel 1 (one launch a tick over streams × chunk
rows); the transducer's greedy lattice walk over every row's chunk (one
kernel-1 launch a lattice step, N = streams); or, for an attention
decoder, one batched beam search over every row that is due a decode,
reading the memory accumulated on the device.

Threads: ``_lock`` guards the slots' host state, ``_tick_lock`` serializes
the device steps (every launch happens under it); the PARTIAL/FINAL
callbacks run outside both locks.

Under a ``torch.profiler`` session a tick records its spans
(``profiling.span``): ``multistream.tick`` around ``multistream.pack`` (the
per-slot loop under the lock), ``multistream.advance`` (the copies to the
device, the encoder and the head's step up to its host read, timed on the
device too), ``multistream.wait`` (that read) and ``multistream.collect``
(the per-slot ``_collect``, the callbacks and the slots freed).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import profiling
from ..data import BLK
from ..utils import GrowingBuffer
from .base import make_memory_search
from .online import (
    best_tokens,
    check_ctc_streamable,
    ctc_frame_ids,
    encode_chunk,
    model_device,
    pad_memory,
    stream_geometry,
    text_of,
)

__all__ = ["MultiStreamAttention", "MultiStreamCTC", "MultiStreamTransducer"]


def _row_where(flags: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-row select, broadcast over the trailing dims."""
    return torch.where(flags.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class _Slot:
    """Host-side state of one stream slot."""

    __slots__ = ("active", "frames", "n_frames", "consumed", "dropped", "emitted", "last_id",
                 "tokens", "finishing", "flush_total", "on_partial", "on_final", "utt_id")

    def __init__(self):
        self.active = False

    def reset(self, utt_id, on_partial, on_final):
        self.active = True
        self.frames: list[np.ndarray] = []   # buffered raw feature frames
        self.n_frames = 0                    # frames pushed, consumed ones included
        self.consumed = 0                    # raw frames consumed by emitted windows
        self.dropped = 0                     # consumed frames discarded from ``frames``
        self.emitted = 0                     # encoder frames emitted
        self.last_id = BLK
        self.tokens: list[int] = []
        self.finishing = False
        self.flush_total: Optional[int] = None  # encoder frames due at the end
        self.on_partial = on_partial
        self.on_final = on_final
        self.utt_id = utt_id


class _MultiStreamBase:
    """N-slot multi-stream server core.

    ``open_stream`` claims a slot, ``push(slot, feats)`` buffers raw feature
    frames, ``close(slot)`` marks the end of the stream; a caller runs
    ``tick()`` whenever ``ready()``: each tick advances every slot with a
    full chunk pending (or a flush under way) in one fused step, calling
    ``on_partial(text)`` when a hypothesis changes and ``on_final(text)``
    when a closed stream drains. Restrictions: a conv frontend and chunked
    attention (``stream_geometry``), and the subclass's own."""

    #: frame-synchronous subclasses append ``_collect``'s tokens; a
    #: label-synchronous one (the attention re-decode) replaces them
    REPLACE_TOKENS = False

    def __init__(self, model, n_streams: int = 4, idx2unit=None):
        geo = stream_geometry(model)
        self.model = model.eval()
        self.idx2unit = idx2unit
        self.n_streams = int(n_streams)
        self.chunk, self.left = geo["chunk"], geo["left"]
        self.hop, self.excess = geo["hop"], geo["excess"]
        self.raw_chunk, self.window = geo["raw_chunk"], geo["window"]
        self.n_feat = model.frontend.input_size
        self.device = model_device(model)
        self.cache = model.encoder.init_stream_cache(self.n_streams)
        self._slots = [_Slot() for _ in range(self.n_streams)]
        self._free: list[int] = list(range(self.n_streams))
        self._fresh = np.zeros((self.n_streams,), bool)
        self._lock = threading.Lock()        # slot / host state
        self._tick_lock = threading.Lock()   # serializes device steps
        self.ticks = 0            # fused steps run (one a tick)
        self.chunks_advanced = 0  # stream chunks advanced over all ticks

    # ---------------------------------------------------------------- hooks
    def _advance_rows(self, window, start, cache_len, chunk_mask, advance, fresh, fin_now):
        """Run the fused step on the device and return the host-side outputs.
        ``fin_now`` bool[B]: rows whose stream completes with this tick."""
        raise NotImplementedError

    def _collect(self, out, row: int, valid: int, slot: _Slot):
        """One advanced row's tokens from the step's outputs: the new ids
        (appended), or with ``REPLACE_TOKENS`` the whole hypothesis, or None
        for "no decode this tick"."""
        raise NotImplementedError

    def _encode(self, window, start, cache_len, chunk_mask, advance, fresh) -> torch.Tensor:
        """Frontend → ``encode_step`` over all rows; rows that do not advance
        keep their caches, fresh rows start from a zero conv state. Returns
        the chunk's memory [N, C, D] on the device."""
        dev = self.device
        args = [torch.from_numpy(a).to(dev) for a in (window, start, cache_len, chunk_mask)]
        adv = torch.from_numpy(advance).to(dev)
        if fresh.any() and "conv" in self.cache[0]:
            keep = torch.from_numpy(~fresh).to(dev)
            self.cache = [dict(lc, conv=_row_where(keep, lc["conv"], torch.zeros_like(lc["conv"])))
                          for lc in self.cache]
        y, new_cache = encode_chunk(self.model, args[0], self.cache, *args[1:])
        self.cache = [{key: _row_where(adv, val, old[key]) for key, val in nc.items()}
                      for nc, old in zip(new_cache, self.cache)]
        return y

    # ------------------------------------------------------------ lifecycle
    def open_stream(self, utt_id: str, on_partial: Callable[[str], None],
                    on_final: Callable[[str], None],
                    timeout: Optional[float] = None) -> Optional[int]:
        """Claim a slot (blocks until one frees; None after ``timeout`` s)."""
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._free:
                    i = self._free.pop(0)
                    self._slots[i].reset(utt_id, on_partial, on_final)
                    self._fresh[i] = True
                    return i
            if end is not None and time.monotonic() >= end:
                return None
            time.sleep(0.002)

    def push(self, slot: int, feats: np.ndarray) -> None:
        """Buffer raw feature frames f32[T, F] for a stream."""
        s = self._slots[slot]
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.n_feat:
            raise ValueError(f"expected [T, {self.n_feat}] frames, got {feats.shape}")
        with self._lock:
            if not s.active or s.finishing:
                raise RuntimeError("push on an inactive or closed stream")
            s.frames.append(feats)
            s.n_frames += feats.shape[0]

    def close(self, slot: int) -> None:
        """Mark the end of the stream; the slot drains over the next ticks. A
        stream too short for any encoder frame finalizes here."""
        s = self._slots[slot]
        finalize = False
        with self._lock:
            s.finishing = True
            s.flush_total = self.model.frontend.output_length(s.n_frames)
            remaining = s.flush_total - s.emitted
            if remaining > 0:
                # zero-pad so that every remaining window is full
                need = s.consumed + (-(-remaining // self.chunk)) * self.raw_chunk + self.excess
                if need > s.n_frames:
                    s.frames.append(np.zeros((need - s.n_frames, self.n_feat), np.float32))
                    s.n_frames = need
            else:
                s.active = False
                finalize = True
        if finalize:
            text, on_final = text_of(s.tokens, self.idx2unit), s.on_final
            with self._lock:
                self._free.append(slot)
            on_final(text)

    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    # ----------------------------------------------------------------- tick
    def _pending(self, s: _Slot) -> int:
        """Valid encoder frames the slot's next window emits (0: idle)."""
        if not s.active:
            return 0
        full = s.n_frames >= s.consumed + self.window
        if s.finishing:
            remaining = s.flush_total - s.emitted
            return min(self.chunk, remaining) if remaining > 0 and full else 0
        return self.chunk if full else 0

    def ready(self) -> bool:
        with self._lock:
            return any(self._pending(s) for s in self._slots)

    def tick(self) -> int:
        """Advance every slot with a pending chunk; returns the number of
        slots advanced. Threads may call it concurrently (ticks serialize)."""
        with self._tick_lock, profiling.span("multistream.tick"):
            return self._tick_inner()

    def _tick_inner(self) -> int:
        n = self.n_streams
        with profiling.span("multistream.pack"), self._lock:
            plan = []  # (slot index, valid frames)
            window = np.zeros((n, self.window, self.n_feat), np.float32)
            start = np.zeros((n,), np.int64)
            cache_len = np.zeros((n,), np.int64)
            chunk_mask = np.zeros((n, self.chunk), bool)
            advance = np.zeros((n,), bool)
            fin_now = np.zeros((n,), bool)
            fresh = self._fresh.copy()
            for i, s in enumerate(self._slots):
                v = self._pending(s)
                if v == 0:
                    continue
                fin_now[i] = bool(s.finishing and s.emitted + v >= s.flush_total)
                if len(s.frames) > 1 or s.consumed - s.dropped >= self.raw_chunk:
                    # consolidate lazily and drop the consumed prefix, so a
                    # long stream holds what is pending, not all it sent
                    buf = np.concatenate(s.frames, axis=0) if len(s.frames) > 1 else s.frames[0]
                    s.frames = [buf[s.consumed - s.dropped:]]
                    s.dropped = s.consumed
                lo = s.consumed - s.dropped
                window[i] = s.frames[0][lo: lo + self.window]
                start[i] = s.emitted
                cache_len[i] = min(self.left, s.emitted)
                chunk_mask[i, :v] = True
                advance[i] = True
                plan.append((i, v))
            if not plan:
                return 0

        with torch.inference_mode():
            out = self._advance_rows(window, start, cache_len, chunk_mask, advance, fresh,
                                     fin_now)
        self.ticks += 1
        self.chunks_advanced += len(plan)

        with profiling.span("multistream.collect"):
            return self._collect_all(out, plan)

    def _collect_all(self, out, plan) -> int:
        """The advanced slots' tokens, their PARTIAL and FINAL callbacks,
        and the finished slots freed."""
        finals, partials = [], []
        with self._lock:
            for i, v in plan:
                s = self._slots[i]
                self._fresh[i] = False
                s.consumed += self.raw_chunk
                s.emitted += v
                new_toks = self._collect(out, i, v, s)
                if self.REPLACE_TOKENS:
                    changed = new_toks is not None and list(new_toks) != s.tokens
                    if changed:
                        s.tokens = list(new_toks)
                else:
                    changed = bool(new_toks)
                    s.tokens.extend(new_toks)
                if s.finishing and s.emitted >= s.flush_total:
                    s.active = False
                    finals.append((i, s))
                elif changed:
                    partials.append(s)
        # callbacks outside the locks (they may write to sockets); a slot is
        # free before its FINAL goes out (the text and callback taken first,
        # as the slot may be claimed again at once), so a client that has
        # read its FINAL finds the slot free
        for s in partials:
            s.on_partial(text_of(s.tokens, self.idx2unit))
        for i, s in finals:
            text, on_final = text_of(s.tokens, self.idx2unit), s.on_final
            with self._lock:
                self._free.append(i)
            on_final(text)
        return len(plan)

    # ---------------------------------------------------------- convenience
    def run_stream(self, feats: np.ndarray, on_partial: Callable[[str], None]) -> str:
        """Feed one whole utterance through a slot and drive ticks until it
        finishes. Concurrent callers cooperate: each tick advances every
        caller's stream at once."""
        result = {}
        slot = self.open_stream("u", on_partial, lambda text: result.setdefault("text", text))
        self.push(slot, feats)
        self.close(slot)
        while "text" not in result:
            if not self.ready() or self.tick() == 0:
                time.sleep(0.001)
        return result["text"]


class MultiStreamCTC(_MultiStreamBase):
    """Multi-stream greedy CTC: the tick ends in the CTC head's top-1
    through kernel 1 (one launch a tick over all N × C rows); ids collapse
    on the host a stream at a time (blank = PAD = 0)."""

    def __init__(self, model, n_streams: int = 4, idx2unit=None):
        check_ctc_streamable(model, "multi-stream CTC")
        super().__init__(model, n_streams, idx2unit)

    def _advance_rows(self, window, start, cache_len, chunk_mask, advance, fresh, fin_now):
        with profiling.span("multistream.advance", self.device):
            y = self._encode(window, start, cache_len, chunk_mask, advance, fresh)
            ids = ctc_frame_ids(self.model, y)
        with profiling.span("multistream.wait"):
            return ids.cpu().numpy()

    def _collect(self, ids, row, valid, s):
        new = []
        for t in range(valid):
            tok = int(ids[row, t])
            if tok != BLK and tok != s.last_id:
                new.append(tok)
            s.last_id = tok
        return new


class MultiStreamTransducer(_MultiStreamBase):
    """Multi-stream greedy transducer: the tick runs the resumable
    ``greedy_frames`` lattice walk over every row, each with its chunk's
    valid frames (a row without a chunk has 0 and is never stepped). The
    prediction network's state and hidden stay on the device a row each,
    and restart from BOS when a slot starts a new stream (``fresh``). A
    stream's hypothesis equals ``StreamingTransducerRecognizer``'s wherever
    ``max_symbols`` does not bind."""

    def __init__(self, model, n_streams: int = 4, idx2unit=None, max_symbols: int = 10_000,
                 max_per_frame: int = 8):
        super().__init__(model, n_streams, idx2unit)
        self.max_symbols = int(max_symbols)
        self.max_per_frame = int(max_per_frame)
        with torch.inference_mode():
            self._state, self._hidden = model.init_decode_state(self.n_streams)

    def _advance_rows(self, window, start, cache_len, chunk_mask, advance, fresh, fin_now):
        with profiling.span("multistream.advance", self.device):
            y = self._encode(window, start, cache_len, chunk_mask, advance, fresh)
            if fresh.any():
                new = torch.from_numpy(fresh).to(self.device)
                s0, h0 = self.model.init_decode_state(self.n_streams)
                self._state = _row_where(new, s0, self._state)
                self._hidden = [(_row_where(new, c0, c), _row_where(new, x0, x))
                                for (c0, x0), (c, x) in zip(h0, self._hidden)]
            frame_len = torch.from_numpy(chunk_mask.sum(axis=1)).to(self.device)
            toks, n, self._state, self._hidden = self.model.greedy_frames(
                y, frame_len, self._state, self._hidden, self.chunk * self.max_per_frame,
                self.max_per_frame)
        with profiling.span("multistream.wait"):
            return toks.cpu().numpy(), n.cpu().numpy()

    def _collect(self, out, row, valid, s):
        toks, n = out
        room = self.max_symbols - len(s.tokens)
        return toks[row, : min(int(n[row]), room)].tolist()


class MultiStreamAttention(_MultiStreamBase):
    """Multi-stream attention-decoder (speech2text) serving.

    The tick's fused step advances every pending row's encoder; each row's
    emitted memory accumulates on the device, and the rows due a decode
    share one batched beam search (every slot takes part at a fixed batch;
    rows not due carry a one-frame dummy memory whose result is dropped),
    each row masked to its own memory, the time axis padded to
    ``mem_bucket`` multiples. ``partial_every`` throttles a row's PARTIAL
    re-decodes; a finishing row always decodes on its last tick, so its
    FINAL equals the offline beam over the whole chunked memory."""

    REPLACE_TOKENS = True

    def __init__(self, model, n_streams: int = 4, idx2unit=None, beam_width: int = 5,
                 max_len: int = 100, penalty: float = 0.6, lamda: float = 5.0,
                 mem_bucket: int = 64, partial_every: int = 1, eos_id: Optional[int] = None):
        super().__init__(model, n_streams, idx2unit)
        self.mem_bucket = max(1, int(mem_bucket))
        self.partial_every = max(1, int(partial_every))
        self._mem = [GrowingBuffer() for _ in range(self.n_streams)]
        self._since_decode = np.zeros((self.n_streams,), np.int64)
        self.decode_dispatches = 0
        self._search = make_memory_search(self.model, int(beam_width), int(max_len),
                                          float(penalty), float(lamda), eos_id=eos_id)

    def _advance_rows(self, window, start, cache_len, chunk_mask, advance, fresh, fin_now):
        with profiling.span("multistream.advance", self.device):
            y = self._encode(window, start, cache_len, chunk_mask, advance, fresh)
            decode_rows = []
            for i in np.flatnonzero(advance):
                if fresh[i]:
                    self._mem[i] = GrowingBuffer()
                    self._since_decode[i] = 0
                v = int(chunk_mask[i].sum())
                if v:
                    self._mem[i].append(y[i, :v])
                self._since_decode[i] += 1
                if fin_now[i] or self._since_decode[i] >= self.partial_every:
                    decode_rows.append(int(i))
            if not decode_rows:
                return {}
            self._since_decode[decode_rows] = 0
            # rows not due, and due rows without a frame yet, decode a dummy frame
            rows = [self._mem[i].view() if i in decode_rows else None
                    for i in range(self.n_streams)]
            hyp = self._search(*pad_memory(rows, self.mem_bucket, y))
            self.decode_dispatches += 1
        with profiling.span("multistream.wait"):
            return best_tokens(hyp, decode_rows)

    def _collect(self, out, row, valid, s):
        return out.get(row)  # None: no decode this tick, the hypothesis stays
