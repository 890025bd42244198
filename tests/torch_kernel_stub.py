"""One stand-in for the built kernel libraries of the port's ``csrc/``.

Every wrapper under ``opentransformer_tpu_torch/ops/`` calls its kernel
through ``cuda_build.Entry``, which takes the library from
``cuda_build.load`` and launches through ``cuda_build.launch``. The
``kernel_stub`` fixture replaces those two, so that a wrapper's host side
(its checks, its plan, the arguments it hands to the C entry) runs on CPU
tensors: ``load`` returns a ``StubLibrary`` for every library, ``launch``
calls the entry with a stream handle of 0, and the current device is -1
(what ``get_device`` reads on a CPU tensor). A test module imports the
fixture by name.
"""

import ctypes

import pytest
import torch

from opentransformer_tpu_torch.ops import cuda_build


def _fits(ctype, arg) -> bool:
    if ctype is ctypes.c_void_p:
        return arg is None or type(arg) is int
    if ctype is ctypes.c_float:
        return type(arg) is float
    bits = 8 * ctypes.sizeof(ctype)
    return type(arg) is int and -(1 << (bits - 1)) <= arg < 1 << (bits - 1)


class StubLibrary:
    """Stands in for every built kernel library: each launch entry checks
    its arguments against the ``argtypes`` set on it (their number, and
    each one a value of its C type, as ctypes would convert it), records
    ``(symbol, args)`` in ``calls`` and returns ``code`` (0, success,
    unless a test sets it); ``<lib>_error_string(code)`` names the code."""

    def __init__(self):
        self.calls = []
        self.code = 0

    def __getattr__(self, symbol):
        if symbol.startswith("_"):
            raise AttributeError(symbol)
        if symbol.endswith("_error_string"):
            def entry(code):
                return f"stub error {code}".encode()
        else:
            def entry(*args):
                types = entry.argtypes
                if len(types) != len(args) or not all(map(_fits, types, args)):
                    raise TypeError(f"{symbol}: {args} do not fit {types}")
                self.calls.append((symbol, args))
                return self.code
        setattr(self, symbol, entry)
        return entry


@pytest.fixture
def kernel_stub(monkeypatch):
    lib = StubLibrary()
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    monkeypatch.setattr(cuda_build, "launch", lambda fn, index, args: fn(*args, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    return lib
