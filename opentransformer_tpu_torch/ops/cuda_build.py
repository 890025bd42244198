"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/<name>-<hash>.so`` (the directory is gitignored; the hash
covers the source, the ``csrc/*.cuh`` headers it may include and the flags,
so an edited source or header rebuilds), then loaded with ``ctypes``. No
PyTorch headers are involved, so a build takes seconds. Nothing is built or
loaded when this module is imported.

Every wrapper under ``ops/`` calls its kernel through ``Entry``: a C launch
entry of one library, called on a device's current stream (``launch``),
whose non-zero return raises with the library's own error string.
``DTYPE_CODE`` and ``rows_aligned`` are the type codes and the 16-byte row
rule the entries share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

# the code of a tensor type in the entries' ``dtype`` arguments (csrc/*.cu)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
                           "the port's CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists; returns
    the library path. nvcc's output (ptxas -v lines) goes beside it."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_all(names: list[str]) -> list[str]:
    """``build`` for several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def build_log(name: str) -> str:
    """nvcc's output of the current build of ``name`` (ptxas -v lines)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib


def stream_getter(c_module=torch._C):
    """``device index -> the raw handle of its current stream``: the binding
    that ``torch.cuda.current_stream`` calls, without building a
    ``torch.cuda.Stream`` (~6 µs of host a call less), looked up once; a
    torch without that private binding (a CPU-only build has none) takes
    the public route."""
    raw = getattr(c_module, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


current_stream = stream_getter()


def launch(fn, index: int, args) -> int:
    """``fn(*args, stream)`` on CUDA device ``index`` and its current
    stream, entering the device only when it is not the current one (on
    every decode path it is: entering and leaving costs ~12 µs of host)."""
    if index == torch.cuda.current_device():
        return fn(*args, current_stream(index))
    with torch.cuda.device(index):
        return fn(*args, current_stream(index))


# ctypes type of each letter of an ``Entry`` signature
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float}


class Entry:
    """The C launch entry ``symbol`` of ``csrc/<lib>.cu``, whose arguments
    are ``signature``, one letter each (p pointer, i int, l long long, f
    float), followed by the stream handle every entry ends with.

    ``entry(index, *args)`` launches it on CUDA device ``index``'s current
    stream and raises ``RuntimeError`` with ``<lib>_error_string`` and the
    code when it returns non-zero. The library is taken from ``load`` at
    every call and its argument types are set once per loaded library, so
    a rebuilt and reloaded library (``_loaded`` cleared) is picked up."""

    __slots__ = ("lib", "symbol", "argtypes", "_bound")

    def __init__(self, lib: str, symbol: str, signature: str):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
        self._bound = (None, None)

    def _bind(self, lib):
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        err = getattr(lib, self.lib + "_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        self._bound = (lib, fn)
        return fn

    def __call__(self, index: int, *args) -> None:
        lib = load(self.lib)
        bound, fn = self._bound
        err = launch(fn if bound is lib else self._bind(lib), index, args)
        if err != 0:
            msg = getattr(lib, self.lib + "_error_string")(err).decode()
            raise RuntimeError(f"{self.symbol} failed: {msg} ({err})")


def rows_aligned(*tensors) -> bool:
    """Every tensor's rows start on 16 bytes, as the kernels' 16-byte loads
    need: its innermost stride 1, its address a multiple of 16 and every
    other stride a whole number of 16-byte vectors."""
    for t in tensors:
        st, size = t.stride(), t.element_size()
        if st[-1] != 1 or t.data_ptr() % 16 or any(x * size % 16 for x in st[:-1]):
            return False
    return True
