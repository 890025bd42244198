"""Kaldi ark/scp I/O (counterpart of ``opentransformer_tpu/data/kaldi_io.py``).

Binary archives with float/double matrices ("FM"/"DM") and vectors,
compressed matrices ("CM" method 1: per-column uint8 codes with percentile
headers), and scp ``utt path:offset`` indirection.

Format notes (kaldi src/matrix/kaldi-matrix.cc, compressed-matrix.cc):
  * binary marker: ``\\x00B``
  * token: ascii name + space (e.g. ``FM ``)
  * basic int: ``\\x04`` + int32 LE
  * FM payload: rows, cols, then rows*cols float32 row-major
  * CM GlobalHeader: format(int32==1), min_value, range (float32),
    num_rows, num_cols (int32); then num_cols PerColHeader of 4 uint16
    percentiles; then num_cols × num_rows uint8 codes (column-major).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

import numpy as np


def _read_token(f: BinaryIO) -> str:
    chars = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        chars.append(c)
    return b"".join(chars).decode()


def _expect_binary(f: BinaryIO) -> None:
    marker = f.read(2)
    if marker != b"\x00B":
        raise ValueError(f"not a binary kaldi archive (marker={marker!r}); text mode unsupported")


def _read_basic_int(f: BinaryIO) -> int:
    size = f.read(1)[0]
    if size != 4:
        raise ValueError(f"unexpected int size {size}")
    return struct.unpack("<i", f.read(4))[0]


def _uint16_to_float(u: np.ndarray, min_value: float, range_: float) -> np.ndarray:
    return min_value + range_ * (u.astype(np.float32) / 65535.0)


def _read_compressed_matrix(f: BinaryIO) -> np.ndarray:
    fmt, min_value, range_, num_rows, num_cols = struct.unpack("<iffii", f.read(20))
    if fmt != 1:
        raise ValueError(f"unsupported compressed-matrix format {fmt}")
    headers = np.frombuffer(f.read(8 * num_cols), dtype="<u2").reshape(num_cols, 4)
    data = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8).reshape(num_cols, num_rows)
    p0, p25, p75, p100 = (_uint16_to_float(headers[:, i], min_value, range_) for i in range(4))
    c = data.astype(np.float32)
    # kaldi CharToFloat: three linear segments split at code 64 and 192
    lo = c <= 64
    hi = c > 192
    mid = ~lo & ~hi
    p0b, p25b, p75b, p100b = (x[:, None] for x in (p0, p25, p75, p100))
    out = np.where(lo, p0b + (p25b - p0b) * (c / 64.0), 0.0)
    out = np.where(mid, p25b + (p75b - p25b) * ((c - 64.0) / 128.0), out)
    out = np.where(hi, p75b + (p100b - p75b) * ((c - 192.0) / 63.0), out)
    return np.ascontiguousarray(out.T)


def _read_matrix_payload(f: BinaryIO) -> np.ndarray:
    token = _read_token(f)
    if token == "CM":
        return _read_compressed_matrix(f)
    if token in ("FM", "DM"):
        rows = _read_basic_int(f)
        cols = _read_basic_int(f)
        dtype = "<f4" if token == "FM" else "<f8"
        buf = f.read(rows * cols * (4 if token == "FM" else 8))
        return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).astype(np.float32)
    if token in ("FV", "DV"):
        n = _read_basic_int(f)
        dtype = "<f4" if token == "FV" else "<f8"
        return np.frombuffer(f.read(n * (4 if token == "FV" else 8)), dtype=dtype).astype(np.float32)
    raise ValueError(f"unsupported kaldi payload token {token!r}")


def load_mat(rxspecifier: str) -> np.ndarray:
    """Read one matrix from ``path:offset`` (scp entry) or a bare ark path."""
    if ":" in rxspecifier and rxspecifier.rsplit(":", 1)[1].isdigit():
        path, offset = rxspecifier.rsplit(":", 1)
        offset = int(offset)
    else:
        path, offset = rxspecifier, None
    with open(path, "rb") as f:
        if offset is not None:
            f.seek(offset)
        else:
            _read_token(f)  # skip utt id
        _expect_binary(f)
        return _read_matrix_payload(f)


def read_ark(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Iterate (utt_id, matrix) over a binary ark file."""
    with open(path, "rb") as f:
        while True:
            utt = _read_token(f)
            if not utt:
                return
            _expect_binary(f)
            yield utt, _read_matrix_payload(f)


def read_scp(path: str) -> dict[str, str]:
    """utt → rxspecifier map."""
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def _write_token(f: BinaryIO, tok: str) -> None:
    f.write(tok.encode() + b" ")


def write_ark(path: str, items: dict[str, np.ndarray], scp_path: str | None = None) -> None:
    """Write float32 matrices as a binary ark (+ optional scp)."""
    scp_lines = []
    with open(path, "wb") as f:
        for utt, mat in items.items():
            f.write(utt.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00B")
            _write_token(f, "FM")
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            for dim in mat.shape:
                f.write(b"\x04" + struct.pack("<i", dim))
            f.write(mat.tobytes())
            scp_lines.append(f"{utt} {path}:{offset}")
    if scp_path:
        with open(scp_path, "w", encoding="utf-8") as f:
            f.write("\n".join(scp_lines) + "\n")
