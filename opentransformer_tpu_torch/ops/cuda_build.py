"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/<name>-<hash>.so`` (the directory is gitignored; the hash
covers the source and the flags, so an edited source rebuilds), then loaded
with ``ctypes``. No PyTorch headers are involved, so a build takes seconds.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
                           "the port's CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


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
