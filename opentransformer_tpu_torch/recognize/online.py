"""Frame-synchronous online encoding and recognition
(counterpart of ``opentransformer_tpu/recognize/online.py``).

Features arrive in fixed chunks of ``chunk_size · hop`` raw frames; the conv
frontend runs on each chunk plus the ``excess`` frames its receptive field
reaches past the hop boundary (a one-chunk look-ahead), and the encoder's
``encode_step`` advances per-block KV caches of the last ``left_chunks``
chunks (and the conformer's causal-conv state). The streamed memory equals
the offline encode under the chunk mask, so a model trained offline with
``chunk_size`` / ``left_chunks`` serves online unchanged.

Streaming is inference only: every recognizer puts the model in eval mode
and runs each step under ``torch.inference_mode``. Emitted encoder chunks
stay on the model's device; the CTC recognizer takes each frame's top-1
through the fused projection → log-softmax → top-k kernel (k = 1) and
collapses ids on the host; the transducer recognizer resumes its greedy
lattice walk a chunk at a time (kernel 1 at k = 1 in every lattice step);
the attention recognizer re-runs the KV-cached beam search over the memory
accumulated on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import BLK
from ..models.frontend import ConvFrontEnd
from ..utils import GrowingBuffer
from .base import make_memory_search


def _frontend_geometry(frontend: ConvFrontEnd) -> tuple[int, int]:
    """(hop, excess): one frontend output consumes ``hop`` new raw frames and
    its receptive field reaches ``excess`` frames past the hop boundary (4
    and 3 for two 3×3 / stride-2 layers)."""
    k1, k2 = frontend.conv1.kt, frontend.conv2.kt
    s1, s2 = frontend.conv1.stride, frontend.conv2.stride
    hop = s1 * s2
    rf = (k2 - 1) * s1 + k1  # raw frames covered by one output
    return hop, rf - hop


def stream_geometry(model) -> dict:
    """The streaming geometry of a chunked-attention model with a conv
    frontend: chunk, left (encoder frames in the caches), hop, excess,
    raw_chunk (raw frames a chunk) and window (raw frames a step reads)."""
    enc = model.encoder
    if enc.chunk_size <= 0 or enc.left_chunks < 0:
        raise ValueError("streaming needs encoder chunk_size > 0 and left_chunks >= 0")
    if not isinstance(model.frontend, ConvFrontEnd):
        raise NotImplementedError("streaming supports the conv frontend")
    hop, excess = _frontend_geometry(model.frontend)
    chunk = enc.chunk_size
    return {"chunk": chunk, "left": enc.left_chunks * chunk, "hop": hop, "excess": excess,
            "raw_chunk": chunk * hop, "window": chunk * hop + excess}


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def encode_chunk(model, window, cache, start, cache_len, chunk_mask):
    """The fused streamed step: frontend over a raw window [B, window, F] →
    its first ``chunk`` frames → ``encoder.encode_step``. Returns (y [B, C,
    D], new cache)."""
    chunk = model.encoder.chunk_size
    ones = torch.ones(window.shape[:2], dtype=torch.bool, device=window.device)
    x, _ = model.frontend(window.to(model.dtype), ones)
    return model.encoder.encode_step(x[:, :chunk], cache, start, cache_len, chunk_mask)


class StreamingEncoderSession:
    """Incremental encoder for one batched, equal-length feature stream.

    ``feed`` raw chunks of exactly ``raw_chunk`` frames; each feed after
    the first emits ``chunk`` encoder frames (one chunk of latency: the
    frontend's look-ahead). ``flush``/``finish`` emit the tail, zero-padded
    to full windows, up to ``ConvFrontEnd.output_length`` of all frames fed.
    Emitted chunks are tensors on the model's device."""

    def __init__(self, model, batch: int = 1):
        self.model = model.eval()
        self.batch = batch
        geo = stream_geometry(model)
        self.chunk, self.left = geo["chunk"], geo["left"]
        self.hop, self.excess, self.raw_chunk = geo["hop"], geo["excess"], geo["raw_chunk"]
        self.device = model_device(model)
        self.reset()

    def reset(self) -> None:
        """Start a fresh stream."""
        self.cache = self.model.encoder.init_stream_cache(self.batch)
        self._prev: Optional[np.ndarray] = None
        self._finished = False
        self._raw_seen = 0     # raw frames in fully fed chunks
        self._emitted = 0      # encoder frames emitted
        self._outputs: list[torch.Tensor] = []

    @torch.inference_mode()
    def _emit(self, window: np.ndarray, n_valid: int) -> list[torch.Tensor]:
        """Encoder steps over the frontend outputs of ``window``, whose first
        ``n_valid`` outputs are real and the rest pad."""
        window = torch.from_numpy(np.ascontiguousarray(window)).to(self.device)
        new = []
        for s in range(-(-n_valid // self.chunk)):
            lo = s * self.chunk
            valid = min(self.chunk, n_valid - lo)
            w = window[:, lo * self.hop: lo * self.hop + self.raw_chunk + self.excess]
            mask = (torch.arange(self.chunk, device=self.device) < valid).expand(
                self.batch, self.chunk)
            y, self.cache = encode_chunk(self.model, w, self.cache, self._emitted,
                                         min(self.left, self._emitted), mask)
            self._emitted += valid
            new.append(y[:, :valid])
        self._outputs.extend(new)
        return new

    def feed(self, raw: np.ndarray) -> list[torch.Tensor]:
        """Feed f32[B, raw_chunk, F]; returns the newly emitted encoder
        chunks (none on the first feed: the frontend's look-ahead)."""
        if self._finished:
            raise RuntimeError("session already finished")
        raw = np.asarray(raw, np.float32)
        if raw.shape[0] != self.batch or raw.shape[1] != self.raw_chunk:
            raise ValueError(
                f"expected [B={self.batch}, {self.raw_chunk}, F] chunk, got {raw.shape}")
        new = []
        if self._prev is not None:
            new = self._emit(np.concatenate([self._prev, raw[:, : self.excess]], axis=1),
                             self.chunk)
            self._raw_seen += self.raw_chunk
        self._prev = raw
        return new

    def flush(self, tail: Optional[np.ndarray] = None) -> list[torch.Tensor]:
        """Emit the remaining chunks (with an optional final partial chunk of
        fewer than ``raw_chunk`` frames) and close the session; returns only
        the newly emitted chunks."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        parts = [] if self._prev is None else [self._prev]
        if tail is not None and np.asarray(tail).shape[1] > 0:
            tail = np.asarray(tail, np.float32)
            if tail.shape[1] >= self.raw_chunk:
                raise ValueError("tail must be shorter than one chunk; use feed()")
            parts.append(tail)
        if not parts:
            return []
        raw = np.concatenate(parts, axis=1)
        remaining = (self.model.frontend.output_length(self._raw_seen + raw.shape[1])
                     - self._emitted)
        if remaining <= 0:
            return []
        # zero-pad so that every step reads a full window
        need = (-(-remaining // self.chunk)) * self.raw_chunk + self.excess
        if need > raw.shape[1]:
            raw = np.concatenate(
                [raw, np.zeros((self.batch, need - raw.shape[1], raw.shape[2]), np.float32)],
                axis=1)
        return self._emit(raw, remaining)

    def finish(self, tail: Optional[np.ndarray] = None) -> tuple[torch.Tensor, int]:
        """Flush; returns the whole stitched (memory [B, T', D], T')."""
        self.flush(tail)
        if not self._outputs:
            return torch.zeros((self.batch, 0, self.model.encoder.d_model),
                               dtype=self.model.dtype, device=self.device), 0
        return torch.cat(self._outputs, dim=1), self._emitted


def text_of(ids, idx2unit=None) -> str:
    """Token ids → text through ``idx2unit`` (the ids themselves without one)."""
    if idx2unit is None:
        return " ".join(map(str, ids))
    return " ".join(idx2unit.get(i, "<UNK>") for i in ids)


class _StreamingRecognizer:
    """Chunk-fed recognition shared by the online recognizers: ``feed`` and
    ``finish`` route emitted encoder chunks into ``_consume``, which updates
    ``self.tokens``."""

    def __init__(self, model, batch: int = 1, idx2unit=None):
        self.session = StreamingEncoderSession(model, batch)
        self.model = self.session.model
        self.idx2unit = idx2unit
        self.batch = batch
        self.tokens: list[list[int]] = [[] for _ in range(batch)]

    def reset(self) -> None:
        """Start a fresh stream."""
        self.session.reset()
        self.tokens = [[] for _ in range(self.batch)]

    def _consume(self, chunks) -> None:
        raise NotImplementedError

    def feed(self, raw: np.ndarray) -> list[list[int]]:
        """Feed a raw feature chunk; returns the running token ids per stream."""
        self._consume(self.session.feed(raw))
        return [list(t) for t in self.tokens]

    def finish(self, tail: Optional[np.ndarray] = None) -> list[str]:
        """Flush; returns the final transcripts."""
        self._consume(self.session.flush(tail))
        return [text_of(t, self.idx2unit) for t in self.tokens]


def ctc_frame_ids(model, memory) -> torch.Tensor:
    """Each frame's top-1 id i32[B, C] through the fused projection →
    log-softmax → top-k (kernel 1 at k = 1 on the card)."""
    return model.ctc.project_topk(memory, 1)[1][:, :, 0]


def check_ctc_streamable(model, what: str) -> None:
    if model.ctc.lookahead_steps:
        raise NotImplementedError(
            f"{what} requires lookahead_steps=0 (the look-ahead conv mixes future frames "
            "across chunk boundaries)")


class StreamingCTCRecognizer(_StreamingRecognizer):
    """Frame-synchronous greedy CTC: tokens are emitted as chunks arrive (the
    real-time counterpart of ``CTCRecognizer``'s greedy; the same collapse,
    blank = PAD = 0)."""

    def __init__(self, model, batch: int = 1, idx2unit=None):
        check_ctc_streamable(model, "streaming CTC")
        super().__init__(model, batch, idx2unit)
        self._last = np.zeros(batch, np.int64)  # last frame id a stream

    def reset(self) -> None:
        super().reset()
        self._last = np.zeros(self.batch, np.int64)

    def _consume(self, chunks) -> None:
        for y in chunks:
            if y.shape[1] == 0:
                continue
            with torch.inference_mode():
                ids = ctc_frame_ids(self.model, y).cpu().numpy()
            for b in range(ids.shape[0]):
                for t in range(ids.shape[1]):
                    i = int(ids[b, t])
                    if i != BLK and i != self._last[b]:
                        self.tokens[b].append(i)
                    self._last[b] = i


class StreamingTransducerRecognizer(_StreamingRecognizer):
    """Frame-synchronous transducer recognition: the greedy lattice walk
    (``TransducerModel.greedy_frames``) resumes chunk by chunk, the
    prediction network's state and hidden carried across chunks on the
    device. Each chunk's token buffer holds ``chunk · max_per_frame``, so
    nothing is dropped within a chunk; the hypothesis equals the offline
    greedy decode of the chunk-masked memory wherever ``max_symbols`` does
    not bind."""

    def __init__(self, model, batch: int = 1, idx2unit=None, max_symbols: int = 10_000,
                 max_per_frame: int = 8):
        super().__init__(model, batch, idx2unit)
        self.max_symbols = int(max_symbols)
        self.max_per_frame = int(max_per_frame)
        self._buf = self.session.chunk * self.max_per_frame
        self._init_decode()

    @torch.inference_mode()
    def _init_decode(self) -> None:
        self._state, self._hidden = self.model.init_decode_state(self.batch)

    def reset(self) -> None:
        super().reset()
        self._init_decode()

    def _consume(self, chunks) -> None:
        for y in chunks:
            c = y.shape[1]
            if c == 0:
                continue
            frame_len = torch.full((y.shape[0],), c, dtype=torch.long, device=y.device)
            with torch.inference_mode():
                toks, n, self._state, self._hidden = self.model.greedy_frames(
                    y, frame_len, self._state, self._hidden, self._buf, self.max_per_frame)
            toks, n = toks.cpu().numpy(), n.cpu().numpy()
            for b in range(toks.shape[0]):
                room = self.max_symbols - len(self.tokens[b])
                self.tokens[b].extend(toks[b, : min(int(n[b]), room)].tolist())


def pad_memory(rows, bucket: int, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row memories [T_i, D] zero-padded into one batch [B, T_pad, D], T_pad
    the longest T_i rounded up to a multiple of ``bucket``, with its mask
    bool[B, T_pad]. A row that is None or has no frame gets one valid zero
    frame: a dummy whose result the caller drops. ``like`` gives D, the
    dtype and the device."""
    t_max = max([1] + [r.shape[0] for r in rows if r is not None])
    t_pad = -(-t_max // bucket) * bucket
    memory = torch.zeros((len(rows), t_pad, like.shape[-1]), dtype=like.dtype,
                         device=like.device)
    lens = torch.ones(len(rows), dtype=torch.long)
    for i, r in enumerate(rows):
        if r is not None and r.shape[0]:
            memory[i, : r.shape[0]] = r
            lens[i] = r.shape[0]
    mask = torch.arange(t_pad)[None, :] < lens[:, None]
    return memory, mask.to(like.device)


def best_tokens(hyp, rows) -> dict[int, list[int]]:
    """{row: best hypothesis' ids} without BOS (``lengths`` count BOS and
    exclude EOS)."""
    toks, lens = hyp.tokens[:, 0].cpu().numpy(), hyp.lengths[:, 0].cpu().numpy()
    return {r: toks[r, 1: int(lens[r])].tolist() for r in rows}


class StreamingAttentionRecognizer(_StreamingRecognizer):
    """Incremental attention-decoder (speech2text) recognition.

    An attention decoder is label-synchronous, so a PARTIAL transcript is a
    re-run of the KV-cached beam search over the memory accumulated so far
    (on the device), and the FINAL one equals the offline beam over the same
    chunked memory: the streamed encode equals the chunk-masked encode, and
    the padding to ``mem_bucket`` frames is masked out of the attention.
    ``partial_every`` re-decodes every Nth feed; ``finish`` always decodes."""

    def __init__(self, model, batch: int = 1, idx2unit=None, beam_width: int = 5,
                 max_len: int = 100, penalty: float = 0.6, lamda: float = 5.0,
                 mem_bucket: int = 64, partial_every: int = 1, eos_id: Optional[int] = None):
        super().__init__(model, batch, idx2unit)
        self.mem_bucket = max(1, int(mem_bucket))
        self.partial_every = max(1, int(partial_every))
        self._mem = GrowingBuffer(axis=1)  # accumulated [B, T', D]
        self._feeds = 0
        self._search = make_memory_search(self.model, int(beam_width), int(max_len),
                                          float(penalty), float(lamda), eos_id=eos_id)

    def reset(self) -> None:
        super().reset()
        self._mem = GrowingBuffer(axis=1)
        self._feeds = 0

    def _redecode(self) -> None:
        cur = self._mem.view()
        if cur is None or cur.shape[1] == 0:
            return
        with torch.inference_mode():
            hyp = self._search(*pad_memory(list(cur), self.mem_bucket, cur))
        best = best_tokens(hyp, range(self.batch))
        self.tokens = [best[b] for b in range(self.batch)]

    def _consume(self, chunks) -> None:
        added = False
        for y in chunks:
            if y.shape[1] > 0:
                self._mem.append(y)
                added = True
        if added:
            self._feeds += 1
            if self._feeds % self.partial_every == 0:
                self._redecode()

    def finish(self, tail: Optional[np.ndarray] = None) -> list[str]:
        self._consume(self.session.flush(tail))
        self._redecode()  # the FINAL always reflects the whole memory
        return [text_of(t, self.idx2unit) for t in self.tokens]


class OnlineRecognizerAdapter:
    """The eval CLI's front for the streaming recognizers (``--online``):
    each utterance is fed chunk by chunk, as if arriving in real time, so
    the online path's CER and RTF are measured by the decode CLI."""

    def __init__(self, model_type: str, model, idx2unit=None, max_per_frame: int = 8,
                 beam_width: int = 5, max_len: int = 100, penalty: float = 0.6,
                 lamda: float = 5.0):
        if model_type == "ctc":
            self._rec = StreamingCTCRecognizer(model, batch=1, idx2unit=idx2unit)
        elif model_type == "transducer":
            self._rec = StreamingTransducerRecognizer(model, batch=1, idx2unit=idx2unit,
                                                      max_per_frame=max_per_frame)
        elif model_type == "speech2text":
            self._rec = StreamingAttentionRecognizer(
                model, batch=1, idx2unit=idx2unit, beam_width=beam_width, max_len=max_len,
                penalty=penalty, lamda=lamda)
        else:
            raise NotImplementedError(
                f"--online supports ctc, transducer and speech2text models (got {model_type!r})")

    def recognize(self, feats, feat_mask):
        """(texts [B][1], zero scores f32[B, 1]) for padded features and mask
        (tensors or arrays)."""
        feats = torch.as_tensor(feats).float().cpu().numpy()
        lens = torch.as_tensor(feat_mask).sum(dim=1).cpu().numpy().astype(int)
        rc = self._rec.session.raw_chunk
        texts = []
        for i in range(feats.shape[0]):
            self._rec.reset()
            x = feats[i: i + 1, : lens[i]]
            n_full = x.shape[1] // rc
            for s in range(n_full):
                self._rec.feed(x[:, s * rc:(s + 1) * rc])
            texts.append([self._rec.finish(x[:, n_full * rc:])[0]])
        return texts, np.zeros((feats.shape[0], 1), np.float32)
