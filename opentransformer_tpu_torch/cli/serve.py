"""Serving CLI (counterpart of ``opentransformer_tpu/cli/serve.py``).

Serves a checkpoint on the card: ``-m`` (an expdir, a checkpoint
directory or a reference ``.pt``, with ``-c`` as the eval CLI takes them;
the run config's data section sets the features and the vocabulary), or
npz weights (``--npz``, with ``--model_cfg`` as the eval CLI takes it):

  * requests are ``utt_id wav_path`` lines from a file or stdin (``-i``)
    or from line-based TCP connections (``--port``); the wav becomes
    log-fbank features on the host with the model's data section (the
    extractor, kaldi-compatible or ``psf``, mel bins, global or
    per-utterance CMVN), read from the run config of ``-m`` or from a
    training run's ``config.json`` when ``--model_cfg`` is one;
  * the dynamic batcher groups pending requests into batches of
    ``--max-batch`` rows within ``--batch-timeout-ms``, each padded to the
    next of ``--bucket-frames`` (rows without a request carry one valid
    frame and are dropped), decodes them with the model's recognizer (kernel
    1 in every beam step; kernel 2 with ``-lm``) and answers
    ``utt_id<TAB>text``; ``stats()`` reports latency percentiles and RTFx;
  * ``--streaming`` (a chunked-attention ``ctc``, ``transducer`` or
    ``speech2text`` model):
    ``--streams`` slots advance together, one fused step a tick
    (``recognize/multistream.py``), answering ``utt<TAB>PARTIAL<TAB>text``
    lines as a hypothesis grows and then ``utt<TAB>FINAL<TAB>text``. Over
    TCP a connection sends wav lines, or speaks the PCM protocol: a header
    ``PCM <utt_id> <sample_rate>\\n``, then frames of a u32-LE byte count
    and that many int16-LE mono samples; a count of 0 ends the stream.

    python -m opentransformer_tpu_torch.cli.serve -m EXP -i wav.scp
    python -m opentransformer_tpu_torch.cli.serve --npz W.npz --model_cfg CFG.json \\
        --vocab VOCAB -i wav.scp
    python -m opentransformer_tpu_torch.cli.serve ... --streaming --streams 4 --port 8765

A failed batch, tick or PCM stream is logged and kept: the server raises
it when it stops, so a failure ends in a non-zero exit. It runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import queue
import socketserver
import struct
import sys
import threading
import time

import numpy as np
import torch

from .. import compat
from ..data import load_idx2unit_map
from ..data.datasets import PSF_EXTRACTORS, _read_wav
from ..models.registry import build_model
from ..ops.fbank import fbank_numpy, frame_params, logfbank_psf, normalize_per_utterance
from ..recognize.base import build_recognizer
from ..utils import resolve_device
from .eval import DTYPES, load_lm, load_model_and_lm, load_model_cfg, load_weights, postprocess

logger = logging.getLogger(__name__)



def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve a model with dynamic batching or streaming")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-m", "--load_model",
                     help="expdir, checkpoint directory or reference .pt (as the eval CLI)")
    src.add_argument("--npz", help="flattened npz of the JAX-layout params (needs --model_cfg)")
    p.add_argument("-c", "--config", default=None,
                   help="JSON run config for -m (default: the one that comes with it)")
    p.add_argument("--model_cfg", default=None,
                   help="--npz: JSON model config, an export manifest with a model_cfg key, or "
                        "a training run's config.json (whose data section sets the features)")
    p.add_argument("--vocab", default=None,
                   help="'unit idx' vocab file (default: data.vocab of a training config)")
    p.add_argument("-i", "--input", default=None,
                   help="wav.scp-format request source ('-' = stdin); omit with --port")
    p.add_argument("-o", "--output", default="-",
                   help="where to write 'utt_id<TAB>text' lines ('-' = stdout)")
    p.add_argument("--port", type=int, default=None,
                   help="serve line-based TCP on this port instead of -i (0: any free port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=8,
                   help="requests per device batch (every batch pads to this)")
    p.add_argument("--batch-timeout-ms", type=float, default=30.0,
                   help="max wait to fill a batch before running it")
    p.add_argument("--bucket-frames", default="200,400,800,1600",
                   help="frame buckets; each request pads to the next bucket")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket shape once before accepting requests")
    p.add_argument("--streaming", action="store_true",
                   help="frame-synchronous session mode (ctc, transducer, speech2text): PARTIAL "
                        "hypotheses per chunk, then a FINAL result")
    p.add_argument("--streams", type=int, default=2,
                   help="concurrent streaming slots; all advance in one fused step a tick")
    p.add_argument("-mt", "--max_tokens_per_chunk", type=int, default=8,
                   help="transducer: max emissions per encoder frame")
    p.add_argument("-bw", "--beam_width", type=int, default=5)
    p.add_argument("-nb", "--nbest", type=int, default=1)
    p.add_argument("-pn", "--penalty", type=float, default=0.6)
    p.add_argument("-ld", "--lamda", type=float, default=5.0)
    p.add_argument("-ml", "--max_len", type=int, default=100)
    p.add_argument("-lm", "--load_language_model", default=None,
                   help="LM: an npz with --lm_cfg, a checkpoint directory or a reference .pt "
                        "(as the eval CLI)")
    p.add_argument("--lm_cfg", default=None, help="JSON config of the LM")
    p.add_argument("-lmw", "--lm_weight", type=float, default=0.1)
    p.add_argument("-p2w", "--piece2word", action="store_true")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p


def load_data_cfg(path: str) -> dict:
    """The data section of a training run's ``config.json`` ({} for a bare
    model config or an export manifest: the defaults then apply)."""
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    return dict(cfg.get("data", {})) if "model" in cfg else {}


class FeatureExtractor:
    """wav path → normalized log-fbank f32[T, F], as the eval path of the
    online dataset: kaldi-compatible fbank (or the python_speech_features
    one, ``feature_extractor: psf``) on the host, then global or
    per-utterance CMVN."""

    def __init__(self, data_cfg: dict):
        self.num_mel_bins = int(data_cfg.get("num_mel_bins", 40))
        self.flavor = data_cfg.get("feature_extractor", "torchaudio")
        self.normalization = bool(data_cfg.get("normalization", False))
        self.global_mean = self.global_std = None
        if self.normalization and "global_cmvn" in data_cfg:
            base = data_cfg["global_cmvn"]
            self.global_mean = np.load(base + ".mean.npy")
            self.global_std = np.load(base + ".std.npy")

    def from_samples(self, wav: np.ndarray, sample_rate: float) -> np.ndarray:
        extract = logfbank_psf if self.flavor in PSF_EXTRACTORS else fbank_numpy
        feat = extract(wav, sample_freq=sample_rate, num_mel_bins=self.num_mel_bins)
        if self.normalization:
            if self.global_mean is not None:
                feat = (feat - self.global_mean) / self.global_std
            else:
                feat = normalize_per_utterance(feat)
        return feat.astype(np.float32)

    def __call__(self, wav_path: str) -> np.ndarray:
        sr, wav = _read_wav(wav_path)
        return self.from_samples(wav, sr)


class StreamingFbank:
    """Incremental kaldi fbank over arriving samples: snip-edges framing
    (frame t covers samples [t·shift, t·shift + window)), so a frame is final
    as soon as its window fills and the streamed features equal the whole
    utterance's. CMVN online: global statistics apply as they are; a
    per-utterance config uses causal running CMVN, frame t normalized by
    the scalar mean and std of every value of frames ≤ t. The ``psf``
    extractor frames differently and extracts once, at ``finish``, with
    exact per-utterance CMVN, as the JAX server does."""

    def __init__(self, extractor: FeatureExtractor, sample_rate: float):
        self.ex = extractor
        self.sr = float(sample_rate)
        self.ws, self.shift, _ = frame_params(self.sr, 25.0, 10.0)
        self.buf = np.zeros((0,), np.float32)
        self.frames_done = 0
        self._cmvn_n = 0
        self._cmvn_sum = 0.0
        self._cmvn_sumsq = 0.0

    def _causal_cmvn(self, feat: np.ndarray) -> np.ndarray:
        k = feat.shape[1]
        csum = self._cmvn_sum + np.cumsum(feat.sum(axis=1, dtype=np.float64))
        csumsq = self._cmvn_sumsq + np.cumsum((feat.astype(np.float64) ** 2).sum(axis=1))
        n = self._cmvn_n + k * np.arange(1, feat.shape[0] + 1)
        mean = csum / n
        std = np.maximum(np.sqrt(np.maximum(csumsq / n - mean ** 2, 0.0)), 1e-10)
        self._cmvn_sum, self._cmvn_sumsq, self._cmvn_n = float(csum[-1]), float(csumsq[-1]), int(n[-1])
        return ((feat - mean[:, None]) / std[:, None]).astype(np.float32)

    def _extract(self, final: bool = False) -> np.ndarray:
        n = len(self.buf)
        avail = 0 if n < self.ws else 1 + (n - self.ws) // self.shift
        if avail <= 0:
            return np.zeros((0, self.ex.num_mel_bins), np.float32)
        psf = self.ex.flavor in PSF_EXTRACTORS
        if psf:
            # python_speech_features frames are not snip-edges: the whole
            # utterance is extracted once, at the end
            if not final:
                return np.zeros((0, self.ex.num_mel_bins), np.float32)
            feat = logfbank_psf(self.buf, sample_freq=self.sr, num_mel_bins=self.ex.num_mel_bins)
        else:
            # exactly the samples the new frames cover: snip-edges on the
            # slice gives frames [frames_done, frames_done + avail)
            need = (avail - 1) * self.shift + self.ws
            feat = fbank_numpy(self.buf[:need], sample_freq=self.sr,
                               num_mel_bins=self.ex.num_mel_bins)
            self.buf = self.buf[avail * self.shift:]
            self.frames_done += avail
        if self.ex.normalization:
            if self.ex.global_mean is not None:
                feat = (feat - self.ex.global_mean) / self.ex.global_std
            elif psf:
                feat = normalize_per_utterance(feat)  # the whole utterance at the end
            else:
                feat = self._causal_cmvn(feat)
        return feat.astype(np.float32)

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """[-1, 1]-scaled samples → the newly final frames [T_new, F] (int16
        PCM is divided by 32768 first, the scale the features were made at)."""
        self.buf = np.concatenate([self.buf, np.asarray(samples, np.float32)])
        return self._extract()

    def finish(self) -> np.ndarray:
        return self._extract(final=True)


class _Request:
    __slots__ = ("utt_id", "feats", "reply", "t_in", "t_out")

    def __init__(self, utt_id: str, feats: np.ndarray, reply):
        self.utt_id = utt_id
        self.feats = feats
        self.reply = reply  # callable(utt_id, text)
        self.t_in = time.perf_counter()
        self.t_out = None


class DynamicBatcher:
    """A background thread drains the request queue into batches of shape
    [max_batch, bucket, F]: rows without a request get one valid frame and
    are dropped from the results (their beam work is real). A failed batch
    answers its requests with empty texts and is kept in ``errors``;
    ``drain_and_stop`` raises the first."""

    def __init__(self, recognizer, buckets, max_batch: int = 8, timeout_ms: float = 30.0,
                 piece2word: bool = False):
        self.recognizer = recognizer
        self.buckets = sorted(int(b) for b in buckets)
        self.max_batch = int(max_batch)
        self.timeout = float(timeout_ms) / 1000.0
        self.piece2word = piece2word
        self.device = next(recognizer.model.parameters()).device
        self.q: "queue.Queue[_Request | None]" = queue.Queue()
        self._warned_big: set[int] = set()
        self.latencies: list[float] = []
        self.audio_seconds = 0.0
        self.busy_seconds = 0.0
        self.batches = 0
        self.errors: list[BaseException] = []
        self._nf = 40
        self._stop = threading.Event()
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()

    def submit(self, req: _Request):
        if self._stopping.is_set():
            # a handler that outlived the shutdown wait: answer empty instead
            # of queueing behind the stop sentinel, which is never processed
            req.reply(req.utt_id, "")
            return
        self.q.put(req)

    def drain_and_stop(self):
        """Finish every queued request, stop the thread, and raise the first
        failure of a batch, if any."""
        self._stopping.set()
        self.q.join()
        self._stop.set()
        self.q.put(None)  # wake the loop
        self._thread.join()
        if self.errors:
            raise RuntimeError(f"{len(self.errors)} batches failed") from self.errors[0]

    def set_n_feat(self, nf: int):
        self._nf = int(nf)

    def warmup(self):
        """Run every bucket shape once with a dummy batch."""
        for bucket in self.buckets:
            feats = torch.zeros((self.max_batch, bucket, self._nf), device=self.device)
            mask = torch.ones((self.max_batch, bucket), dtype=torch.bool, device=self.device)
            t0 = time.perf_counter()
            self.recognizer.recognize(feats, mask)
            logger.info("warmup bucket %d: %.1fs", bucket, time.perf_counter() - t0)

    def _loop(self):
        while not self._stop.is_set():
            req = self.q.get()
            if req is None:
                self.q.task_done()
                break
            group = [req]
            deadline = time.perf_counter() + self.timeout
            while len(group) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self.q.task_done()
                    self._stop.set()
                    break
                group.append(nxt)
            try:
                self._run(group)
            except Exception as e:  # kept and raised by drain_and_stop
                logger.exception("batch failed; answering %d requests empty", len(group))
                self.errors.append(e)
                for r in group:
                    r.reply(r.utt_id, "")
            finally:
                for _ in group:
                    self.q.task_done()

    def bucket_for(self, tmax: int) -> int:
        """The next bucket of ``tmax`` frames; beyond the largest, a multiple
        of it (a bounded set of new shapes, no audio dropped)."""
        bucket = next((b for b in self.buckets if b >= tmax), None)
        if bucket is None:
            step = self.buckets[-1]
            bucket = -(-tmax // step) * step
            if bucket not in self._warned_big:
                self._warned_big.add(bucket)
                logger.warning("request of %d frames exceeds the largest bucket %d; padding "
                               "to %d (consider adding it to --bucket-frames)", tmax,
                               self.buckets[-1], bucket)
        return bucket

    def _run(self, group):
        bucket = self.bucket_for(max(r.feats.shape[0] for r in group))
        nf = group[0].feats.shape[1]
        feats = np.zeros((self.max_batch, bucket, nf), np.float32)
        lengths = np.ones((self.max_batch,), np.int64)  # padding rows: one valid frame
        for i, r in enumerate(group):
            feats[i, : r.feats.shape[0]] = r.feats
            lengths[i] = r.feats.shape[0]
        mask = np.arange(bucket)[None] < lengths[:, None]
        t0 = time.perf_counter()
        texts, _ = self.recognizer.recognize(torch.from_numpy(feats).to(self.device),
                                             torch.from_numpy(mask).to(self.device))
        now = time.perf_counter()
        self.busy_seconds += now - t0
        self.batches += 1
        for i, r in enumerate(group):
            r.t_out = now
            self.latencies.append(now - r.t_in)
            self.audio_seconds += r.feats.shape[0] * 0.01
            r.reply(r.utt_id, postprocess(texts[i][0], self.piece2word))

    def stats(self) -> dict:
        lat = sorted(self.latencies)
        if not lat:
            return {"requests": 0}

        def pct(p):
            return lat[min(int(len(lat) * p), len(lat) - 1)]

        return {
            "requests": len(lat),
            "batches": self.batches,
            "latency_ms_p50": round(pct(0.50) * 1000, 1),
            "latency_ms_p90": round(pct(0.90) * 1000, 1),
            "latency_ms_p99": round(pct(0.99) * 1000, 1),
            "audio_seconds": round(self.audio_seconds, 2),
            "device_busy_seconds": round(self.busy_seconds, 2),
            "rtfx_served": round(self.audio_seconds / max(self.busy_seconds, 1e-9), 1),
        }


class MultiStreamFront:
    """Streaming front over ``recognize.multistream``: N concurrent streams
    share one fused step a tick, which a background thread drives whenever
    a stream has a chunk pending. A failed tick stops the thread and is kept
    in ``error``: every waiting stream then raises, and ``stop`` raises it."""

    def __init__(self, model, n_streams: int = 2, idx2unit=None, piece2word: bool = False,
                 model_type: str = "ctc", max_per_frame: int = 8, beam_args: dict | None = None):
        from ..recognize.multistream import (
            MultiStreamAttention,
            MultiStreamCTC,
            MultiStreamTransducer,
        )

        if model_type == "transducer":
            self.ms = MultiStreamTransducer(model, n_streams=n_streams, idx2unit=idx2unit,
                                            max_per_frame=max_per_frame)
        elif model_type == "speech2text":
            self.ms = MultiStreamAttention(model, n_streams=n_streams, idx2unit=idx2unit,
                                           **(beam_args or {}))
        else:
            self.ms = MultiStreamCTC(model, n_streams=n_streams, idx2unit=idx2unit)
        self.piece2word = piece2word
        self.n_sessions = n_streams
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def _drive(self):
        while not self._stop.is_set():
            try:
                advanced = self.ms.ready() and self.ms.tick()
            except Exception as e:  # kept: waiters and stop() raise it
                logger.exception("multi-stream tick failed; the streaming front stops")
                self.error = e
                return
            if not advanced:
                time.sleep(0.002)

    def _check(self):
        if self.error is not None:
            raise RuntimeError("the multi-stream tick failed") from self.error

    def wait(self, done: threading.Event, timeout: float | None = None) -> bool:
        """Wait for ``done``; raises if the tick thread failed meanwhile."""
        end = None if timeout is None else time.monotonic() + timeout
        while not done.wait(0.05):
            self._check()
            if end is not None and time.monotonic() >= end:
                return False
        return True

    def _post(self, text: str) -> str:
        return postprocess(text, self.piece2word)

    def warmup(self, n_feat: int):
        t0 = time.perf_counter()
        self.run_stream(np.zeros((8 * self.ms.raw_chunk, n_feat), np.float32), lambda _: None)
        logger.info("multi-stream warmup: %.1fs (1 fused step a tick, %d slots)",
                    time.perf_counter() - t0, self.n_sessions)

    def run_stream(self, feats: np.ndarray, on_partial) -> str:
        done = threading.Event()
        result = {}

        def on_final(text):
            result["text"] = text
            done.set()

        self._check()
        slot = self.ms.open_stream("u", lambda t: on_partial(self._post(t)), on_final)
        self.ms.push(slot, feats)
        self.ms.close(slot)
        self.wait(done)
        return self._post(result["text"])

    # incremental API of the PCM transport
    def open_stream(self, utt_id, on_partial, on_final):
        self._check()
        return self.ms.open_stream(utt_id, lambda t: on_partial(self._post(t)),
                                   lambda t: on_final(self._post(t)))

    def push(self, slot, feats):
        self.ms.push(slot, feats)

    def close(self, slot):
        self.ms.close(slot)

    def stop(self):
        self._stop.set()
        self._thread.join()
        self._check()


def load_served_model(args):
    """(model type, model, LM or None, data section, vocab path) from the
    CLI's loading flags."""
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if args.load_model:
        model, cfg, lm = load_model_and_lm(args.load_model, args.config,
                                           args.load_language_model, args.lm_cfg, dtype, dev)
        model_cfg, data_cfg = cfg["model"], dict(cfg.get("data", {}))
    else:
        if not args.model_cfg:
            raise SystemExit("error: --npz needs --model_cfg")
        model_cfg = load_model_cfg(args.model_cfg)
        data_cfg = load_data_cfg(args.model_cfg)
        model = load_weights(build_model(model_cfg, dtype=dtype, device=dev),
                             compat.params_from_jax(compat.load_npz(args.npz)))
        lm = None
        if args.load_language_model:
            if not args.lm_cfg:
                raise SystemExit("error: -lm needs --lm_cfg (the LM's JSON config)")
            lm = load_lm(args.load_language_model, args.lm_cfg, dtype, dev)
    vocab = args.vocab or data_cfg.get("vocab")
    if vocab is None:
        raise SystemExit("error: pass --vocab (the model config has no data.vocab)")
    return model_cfg["type"], model, lm, data_cfg, vocab


def _build(args):
    """The loaded model behind a batcher, or behind the streaming front with
    ``--streaming``; and the feature extractor."""
    model_type, model, lm, data_cfg, vocab = load_served_model(args)
    idx2unit = load_idx2unit_map(vocab)
    extractor = FeatureExtractor(data_cfg)
    if args.streaming:
        if model_type not in ("ctc", "transducer", "speech2text"):
            raise SystemExit(f"--streaming does not support {model_type!r} models")
        front = MultiStreamFront(
            model, n_streams=args.streams, idx2unit=idx2unit, piece2word=args.piece2word,
            model_type=model_type, max_per_frame=args.max_tokens_per_chunk,
            beam_args={"beam_width": args.beam_width, "max_len": args.max_len,
                       "penalty": args.penalty, "lamda": args.lamda})
        return front, extractor
    recog_args = {"beam_width": args.beam_width, "nbest": args.nbest, "penalty": args.penalty,
                  "lamda": args.lamda, "max_len": args.max_len, "lm_weight": args.lm_weight,
                  "max_tokens_per_chunk": args.max_tokens_per_chunk}
    recognizer = build_recognizer(model_type, model, lm=lm, args=recog_args, idx2unit=idx2unit)
    batcher = DynamicBatcher(recognizer, [int(b) for b in str(args.bucket_frames).split(",") if b],
                             max_batch=args.max_batch, timeout_ms=args.batch_timeout_ms,
                             piece2word=args.piece2word)
    batcher.set_n_feat(extractor.num_mel_bins)
    return batcher, extractor


def _requests(lines):
    """(utt_id, wav path) of each well-formed request line."""
    for line in lines:
        parts = line.strip().split(maxsplit=1)
        if len(parts) == 2:
            yield parts


def _open_io(args):
    src = sys.stdin if args.input == "-" else open(args.input, "r", encoding="utf-8")
    out = sys.stdout if args.output == "-" else open(args.output, "w", encoding="utf-8")
    return src, out


def _close_io(src, out):
    if src is not sys.stdin:
        src.close()
    if out is not sys.stdout:
        out.close()


def _serve_stream(args, batcher: DynamicBatcher, extractor: FeatureExtractor) -> int:
    src, out = _open_io(args)
    out_lock = threading.Lock()

    def reply(utt_id, text):
        with out_lock:
            out.write(f"{utt_id}\t{text}\n")
            out.flush()

    n = 0
    for utt_id, path in _requests(src):
        try:
            feats = extractor(path)
        except (OSError, ValueError) as e:  # a bad request, not a server failure
            logger.error("feature extraction failed for %s: %s", utt_id, e)
            reply(utt_id, "")
            continue
        batcher.submit(_Request(utt_id, feats, reply))
        n += 1
    try:
        batcher.drain_and_stop()
    finally:
        _close_io(src, out)
    logger.info("served %d requests: %s", n, batcher.stats())
    return 0


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.errors: list[BaseException] = []

    def handle_error(self, request, client_address):
        self.errors.append(sys.exc_info()[1])
        logger.exception("request from %s failed", client_address)

    def raise_errors(self):
        if self.errors:
            raise RuntimeError(f"{len(self.errors)} connections failed") from self.errors[0]


def _serve_forever(srv: _Server, on_ready, what: str) -> None:
    host, port = srv.server_address[:2]
    logger.info("%s on %s:%d", what, host, port)
    if on_ready is not None:
        on_ready(srv)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def _serve_tcp(args, batcher: DynamicBatcher, extractor: FeatureExtractor, on_ready=None) -> int:
    # drain_and_stop may run only after every handler is past its last
    # submit, so the handlers are counted in and out
    inflight = threading.Semaphore(0)
    inflight_n = [0]
    inflight_lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def setup(self):
            super().setup()
            with inflight_lock:
                inflight_n[0] += 1

        def finish(self):
            try:
                super().finish()
            finally:
                inflight.release()

        def handle(self):
            wlock = threading.Lock()
            done = threading.Semaphore(0)

            def reply(utt_id, text):
                with wlock:
                    try:
                        self.wfile.write(f"{utt_id}\t{text}\n".encode())
                        self.wfile.flush()
                    except OSError:
                        pass  # the client went away

            def counted_reply(utt_id, text):
                reply(utt_id, text)
                done.release()

            pending = 0
            for utt_id, path in _requests(raw.decode() for raw in self.rfile):
                try:
                    feats = extractor(path)
                except (OSError, ValueError) as e:  # a bad request
                    logger.error("feature extraction failed for %s: %s", utt_id, e)
                    reply(utt_id, "")
                    continue
                batcher.submit(_Request(utt_id, feats, counted_reply))
                pending += 1
            for _ in range(pending):  # hold the connection until all are answered
                done.acquire()

    with _Server((args.host, args.port), Handler) as srv:
        srv.batcher = batcher
        _serve_forever(srv, on_ready, f"serving (max_batch={batcher.max_batch})")
    with inflight_lock:
        n = inflight_n[0]
    for _ in range(n):
        inflight.acquire(timeout=60)
    batcher.drain_and_stop()
    srv.raise_errors()
    logger.info("shutdown: %s", batcher.stats())
    return 0


def _serve_stream_streaming(args, front: MultiStreamFront, extractor: FeatureExtractor) -> int:
    """Streaming over a wav.scp source, one utterance at a time:
    ``utt<TAB>PARTIAL<TAB>text`` lines as the hypothesis grows, then
    ``utt<TAB>FINAL<TAB>text``."""
    src, out = _open_io(args)
    n, audio_s, t0 = 0, 0.0, time.perf_counter()
    try:
        for utt_id, path in _requests(src):
            try:
                feats = extractor(path)
            except (OSError, ValueError) as e:  # a bad request
                logger.error("feature extraction failed for %s: %s", utt_id, e)
                out.write(f"{utt_id}\tFINAL\t\n")
                continue
            audio_s += feats.shape[0] * 0.01

            def on_partial(text, _u=utt_id):
                out.write(f"{_u}\tPARTIAL\t{text}\n")
                out.flush()

            final = front.run_stream(feats, on_partial)
            out.write(f"{utt_id}\tFINAL\t{final}\n")
            out.flush()
            n += 1
    finally:
        _close_io(src, out)
        front.stop()
    dt = time.perf_counter() - t0
    logger.info("streamed %d utterances (%.1fs audio) in %.1fs (%.1fx realtime)", n, audio_s,
                dt, audio_s / max(dt, 1e-9))
    return 0


def handle_pcm_stream(handler, header: str, front: MultiStreamFront,
                      extractor: FeatureExtractor) -> None:
    """One PCM stream on a connection: after the header line ``PCM <utt_id>
    <sample_rate>``, frames of [u32-LE byte count N][N bytes of int16-LE mono
    samples], N = 0 ending the stream; answers ``utt_id\\tPARTIAL\\ttext``
    lines, then ``utt_id\\tFINAL\\ttext``. Features are made as samples
    arrive (``StreamingFbank``) and pushed into a slot of the front; a
    client that disconnects mid-stream is finalized on what arrived, and
    the slot is released in ``finally`` whatever happens."""
    parts = header.split()
    utt_id = parts[1] if len(parts) > 1 else "stream"
    sr = float(parts[2]) if len(parts) > 2 else 16000.0
    wlock = threading.Lock()

    def say(kind, text):
        with wlock:
            try:
                handler.wfile.write(f"{utt_id}\t{kind}\t{text}\n".encode())
                handler.wfile.flush()
            except OSError:
                pass  # the client went away

    def read_exact(n):
        data = b""
        while len(data) < n:
            more = handler.rfile.read(n - len(data))
            if not more:
                raise EOFError
            data += more
        return data

    sfe = StreamingFbank(extractor, sr)
    done = threading.Event()
    slot = front.open_stream(utt_id, lambda t: say("PARTIAL", t),
                             lambda t: (say("FINAL", t), done.set()))
    try:
        while True:
            (n,) = struct.unpack("<I", read_exact(4))
            if n == 0:
                break
            samples = np.frombuffer(read_exact(n), "<i2").astype(np.float32) / 32768.0
            frames = sfe.feed(samples)
            if len(frames):
                front.push(slot, frames)
    except (EOFError, ConnectionError):
        pass  # the client went away mid-stream: finalize what arrived
    finally:
        tail = sfe.finish()
        if len(tail):
            front.push(slot, tail)
        front.close(slot)
    front.wait(done)


def _serve_tcp_streaming(args, front: MultiStreamFront, extractor: FeatureExtractor,
                         on_ready=None) -> int:
    """TCP streaming: a connection speaks the PCM protocol (first line
    ``PCM <utt_id> <rate>``) or sends ``utt_id wav_path`` lines; either way
    the client receives PARTIAL lines, then a FINAL line a stream."""

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            first = self.rfile.readline()
            if not first:
                return
            text = first.decode(errors="replace").strip()
            if text.startswith("PCM"):
                handle_pcm_stream(self, text, front, extractor)
                return
            for utt_id, path in _requests(raw.decode() for raw in itertools.chain([first],
                                                                                  self.rfile)):
                try:
                    feats = extractor(path)
                except (OSError, ValueError) as e:  # a bad request
                    logger.error("feature extraction failed for %s: %s", utt_id, e)
                    self.wfile.write(f"{utt_id}\tFINAL\t\n".encode())
                    continue

                def on_partial(text, _u=utt_id):
                    try:
                        self.wfile.write(f"{_u}\tPARTIAL\t{text}\n".encode())
                        self.wfile.flush()
                    except OSError:
                        pass  # the client went away

                final = front.run_stream(feats, on_partial)
                try:
                    self.wfile.write(f"{utt_id}\tFINAL\t{final}\n".encode())
                    self.wfile.flush()
                except OSError:
                    return

    with _Server((args.host, args.port), Handler) as srv:
        srv.front = front
        _serve_forever(srv, on_ready, f"streaming ({args.streams} slots)")
    front.stop()
    srv.raise_errors()
    return 0


def main(argv=None, on_ready=None) -> int:
    """The CLI. ``on_ready(server)`` is called once a TCP server is bound
    (with ``--port 0`` its ``server_address`` holds the port the OS chose;
    ``server.batcher`` or ``server.front`` is what it serves through);
    ``server.shutdown()`` from another thread stops it."""
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    if args.port is None and args.input is None:
        raise SystemExit("pass -i <wav.scp|-> or --port N")
    front, extractor = _build(args)
    if args.streaming:
        if args.warmup:
            front.warmup(extractor.num_mel_bins)
        if args.port is not None:
            return _serve_tcp_streaming(args, front, extractor, on_ready)
        return _serve_stream_streaming(args, front, extractor)
    if args.warmup:
        front.warmup()
    front.start()
    if args.port is not None:
        return _serve_tcp(args, front, extractor, on_ready)
    return _serve_stream(args, front, extractor)


if __name__ == "__main__":
    sys.exit(main())
