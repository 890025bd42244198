"""ctypes bindings of the native C++ CTC prefix-beam decoder
(counterpart of ``opentransformer_tpu/recognize/native_ctc.py``).

The decoder is the repository's shared C++ in ``native/ctc_decoder.cc``:
the label-synchronous prefix search on the host, with optional n-gram LM
fusion (an ARPA file, its binary cache or a KenLM PROBING binary; weights
alpha and beta as the reference's ``ctcdecode``). ``native/libctc_decoder.so``
is built with ``make -C native`` at first use; a library that cannot be
built or loaded raises; there is no fallback to the Python prefix search.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO, "native")
SO_PATH = os.path.join(NATIVE_DIR, "libctc_decoder.so")
# serialises the port's builds (the directory is gitignored)
_LOCK_PATH = os.path.join(_REPO, "opentransformer_tpu_torch", "_build", "native_ctc.lock")

_loaded: dict[str, ctypes.CDLL] = {}

_F32P, _I32P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)


def _library() -> ctypes.CDLL:
    """Build (``make`` is a no-op when the library is up to date) and load."""
    if SO_PATH in _loaded:
        return _loaded[SO_PATH]
    os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
    with open(_LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = subprocess.run(["make", "-C", NATIVE_DIR, "libctc_decoder.so"],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {SO_PATH} with make failed ({done.returncode}):\n"
                               f"{done.stdout}{done.stderr}")
        lib = ctypes.CDLL(SO_PATH)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lm_load.restype = p
    lib.lm_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), i]
    lib.lm_free.argtypes = [p]
    lib.lm_free.restype = None
    lib.lm_order.argtypes = [p]
    lib.lm_order.restype = i
    lib.lm_save_binary.argtypes = [p, ctypes.c_char_p]
    lib.lm_save_binary.restype = i
    lib.ctc_beam_decode.argtypes = [_F32P, _I32P, i, i, i, i, i, i, f, f, p, i, i, i,
                                    _I32P, _I32P, _F32P]
    lib.ctc_beam_decode.restype = None
    lib.ctc_beam_decode_sparse.argtypes = [_F32P, _I32P, _F32P, _I32P, i, i, i, i, i, f, f,
                                           p, i, i, i, _I32P, _I32P, _F32P]
    lib.ctc_beam_decode_sparse.restype = None
    _loaded[SO_PATH] = lib
    return lib


class NgramLM:
    """An n-gram LM handle for the decoder: ARPA text, the "OTLM" binary
    cache or a KenLM PROBING binary (detected by magic). Loading an ARPA
    file with ``binary_cache`` writes ``<path>.otbin`` beside it, and later
    loads read that cache unless the ARPA file is newer."""

    def __init__(self, arpa_path: str, vocab_units: Sequence[str], binary_cache: bool = True):
        lib = _library()
        units = (ctypes.c_char_p * len(vocab_units))(*[u.encode("utf-8") for u in vocab_units])
        self._handle = None
        cache = arpa_path + ".otbin"
        from_cache = False
        if binary_cache and os.path.exists(cache) and (
                not os.path.exists(arpa_path)
                or os.path.getmtime(cache) >= os.path.getmtime(arpa_path)):
            self._handle = lib.lm_load(cache.encode(), units, len(vocab_units))
            from_cache = bool(self._handle)
        if not self._handle:
            self._handle = lib.lm_load(arpa_path.encode(), units, len(vocab_units))
        if not self._handle:
            try:
                with open(arpa_path, "rb") as fh:
                    head = fh.read(51)
            except OSError:
                head = b""
            if head.startswith(b"mmap lm http://kheafield.com/code"):
                raise ValueError(
                    f"{arpa_path}: not a loadable KenLM binary (only the plain PROBING layout "
                    "is read; rebuild with `build_binary probing` or pass the ARPA text)")
            raise FileNotFoundError(arpa_path)
        if binary_cache and not from_cache and not arpa_path.endswith(".otbin"):
            # a failed write (a read-only directory) only means the next load parses the text
            lib.lm_save_binary(self._handle, cache.encode())

    @property
    def order(self) -> int:
        return _library().lm_order(self._handle)

    def close(self) -> None:
        """Free the native LM (a handle exists only once the library is loaded)."""
        if getattr(self, "_handle", None):
            _library().lm_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def _outputs(fc: np.ndarray, b: int, t: int, nbest: int):
    """Check the frame counts the C++ reads up to, and allocate (tokens,
    lengths, scores)."""
    if fc.shape != (b,) or (fc < 0).any() or (fc > t).any():
        raise ValueError(f"frame counts must be {b} values in [0, {t}], got {fc.tolist()}")
    return (np.zeros((b, nbest, t), np.int32), np.zeros((b, nbest), np.int32),
            np.zeros((b, nbest), np.float32))


def ctc_beam_decode(log_probs: np.ndarray, frame_counts: np.ndarray, beam_width: int = 10,
                    blank: int = 0, prune_k: int = 32, alpha: float = 0.0, beta: float = 0.0,
                    lm: Optional[NgramLM] = None, nbest: int = 1, num_threads: int = 0):
    """Prefix beam search of frame log-probs f32[B, T, V] → (tokens
    i32[B, nbest, T], lengths i32[B, nbest], scores f32[B, nbest])."""
    lib = _library()
    lp = np.ascontiguousarray(log_probs, np.float32)
    fc = np.ascontiguousarray(frame_counts, np.int32)
    b, t, v = lp.shape
    tokens, lens, scores = _outputs(fc, b, t, nbest)
    lib.ctc_beam_decode(
        lp.ctypes.data_as(_F32P), fc.ctypes.data_as(_I32P), b, t, v, blank, beam_width,
        prune_k, alpha, beta, getattr(lm, "_handle", None), t, nbest, num_threads,
        tokens.ctypes.data_as(_I32P), lens.ctypes.data_as(_I32P), scores.ctypes.data_as(_F32P))
    return tokens, lens, scores


def ctc_beam_decode_sparse(cand_lp: np.ndarray, cand_ids: np.ndarray, blank_lp: np.ndarray,
                           frame_counts: np.ndarray, beam_width: int = 10, blank: int = 0,
                           alpha: float = 0.0, beta: float = 0.0, lm: Optional[NgramLM] = None,
                           nbest: int = 1, num_threads: int = 0):
    """Prefix beam search over each frame's N candidates, as the fused top-k
    gives them (f32[B, T, N] sorted descending, ids i32[B, T, N]) and the
    exact blank log-prob f32[B, T]: only [B, T, N] reaches the host. With N
    equal to ``ctc_beam_decode``'s ``prune_k`` the two agree (up to exact
    ties at the N-th candidate). Returns (tokens i32[B, nbest, T], lengths
    i32[B, nbest], scores f32[B, nbest])."""
    lib = _library()
    lp = np.ascontiguousarray(cand_lp, np.float32)
    ids = np.ascontiguousarray(cand_ids, np.int32)
    blp = np.ascontiguousarray(blank_lp, np.float32)
    fc = np.ascontiguousarray(frame_counts, np.int32)
    b, t, n = lp.shape
    if ids.shape != lp.shape or blp.shape != (b, t):
        raise ValueError(f"shapes disagree: candidates {lp.shape}, ids {ids.shape}, "
                         f"blank {blp.shape}")
    tokens, lens, scores = _outputs(fc, b, t, nbest)
    lib.ctc_beam_decode_sparse(
        lp.ctypes.data_as(_F32P), ids.ctypes.data_as(_I32P), blp.ctypes.data_as(_F32P),
        fc.ctypes.data_as(_I32P), b, t, n, blank, beam_width, alpha, beta,
        getattr(lm, "_handle", None), t, nbest, num_threads,
        tokens.ctypes.data_as(_I32P), lens.ctypes.data_as(_I32P), scores.ctypes.data_as(_F32P))
    return tokens, lens, scores
