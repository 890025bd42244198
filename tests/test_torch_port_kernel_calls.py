"""How the port calls its hand-written kernels (``ops/cuda_build.py``'s
``Entry``), and the host side of kernels 1-3, on the CPU.

Every wrapper under ``ops/`` launches through one ``cuda_build.Entry``: the
library from ``cuda_build.load`` at every call, its argument types set once
per loaded library, the launch on the device's current stream, and a
non-zero return raised with the library's own error string. Here the built
libraries are the shared stub of ``torch_kernel_stub.py``, which also holds
every launch's arguments to the entry's C signature; the wrappers' checks,
split plans and launch arguments run on CPU tensors. The kernels
themselves run only on the card (``tests/test_torch_port_gpu.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch.ops import beam_attention as ba
from opentransformer_tpu_torch.ops import cuda_build
from opentransformer_tpu_torch.ops import encoder_attention as ea
from opentransformer_tpu_torch.ops import fbank_kernel as fk
from opentransformer_tpu_torch.ops import project_topk as pt
from torch_kernel_stub import StubLibrary, kernel_stub  # noqa: F401 (a fixture)


def _normal(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype, copy=True)


def _head(n, d, v, dtype, bias, seed=0):
    """(h [N, D], weight [V, D] in h's dtype, bias f32[V] or None)."""
    return (_normal(n, d, dtype=dtype, seed=seed), _normal(v, d, dtype=dtype, seed=seed + 1),
            _normal(v, seed=seed + 2) if bias else None)


def _frames(n_frames, n_mel=40):
    """(frames f32[F, 400], mel_t, twiddles, mel_ranges) as ``fbank_batch``
    hands them to the kernel."""
    tables = fk.device_bases(n_mel, 16000.0, torch.device("cpu"))
    return _normal(n_frames, 400), tables.mel_t, tables.twiddles, tables.mel_ranges


@pytest.mark.parametrize("n,v,dtype,bias", [
    (10, 4233, torch.float32, True), (500, 4233, torch.bfloat16, False),
    (1, 51866, torch.bfloat16, False), (2560, 300, torch.float32, True)])
def test_kernel1_launch_arguments(kernel_stub, n, v, dtype, bias):
    """Kernel 1 gets h, the weight and the bias where they lie (the zero
    bias made once on the device for a head without one), the type code,
    the split plan, and writes the values, ids and logsumexp it returns."""
    d, k = 64, 5
    h, w, b = _head(n, d, v, dtype, bias)
    before = pt.project_logp_topk.launches
    vals, ids, lse = pt._project_logp_topk_cuda(h, w, b, k)
    ((name, args),) = kernel_stub.calls
    zero = pt._zero_bias(v, h.device)
    assert name == "project_topk_launch"
    assert args[:3] == (h.data_ptr(), w.data_ptr(), (b if bias else zero).data_ptr())
    assert args[3:10] == (cuda_build.DTYPE_CODE[dtype], n, d, v, k, *pt.split_plan(n, v))
    assert args[12:] == (vals.data_ptr(), ids.data_ptr(), lse.data_ptr(), 0)
    assert zero.dtype == torch.float32 and not zero.any()
    assert (vals.shape, ids.shape, lse.shape) == ((n, k), (n, k), (n,))
    assert pt.project_logp_topk.launches == before + 1


@pytest.mark.parametrize("dtype,bias1,bias2", [(torch.float32, True, False),
                                               (torch.bfloat16, False, True)])
def test_kernel2_launch_arguments(kernel_stub, dtype, bias1, bias2):
    """Kernel 2 gets both heads (their widths may differ, a bias-free one
    reads the zero bias), the LM weight as a float, the type code and the
    split plan of the shared N and V."""
    n, d1, d2, v, k = 15, 64, 32, 4233, 5
    h1, w1, b1 = _head(n, d1, v, dtype, bias1)
    h2, w2, b2 = _head(n, d2, v, dtype, bias2, seed=5)
    zero = pt._zero_bias(v, h1.device)
    before = pt.project2_logp_topk.launches
    vals, ids = pt._project2_logp_topk_cuda(h1, w1, b1, h2, w2, b2, 0.3, k)
    ((name, args),) = kernel_stub.calls
    assert name == "project2_topk_launch"
    assert args[:6] == (h1.data_ptr(), w1.data_ptr(), (b1 if bias1 else zero).data_ptr(),
                        h2.data_ptr(), w2.data_ptr(), (b2 if bias2 else zero).data_ptr())
    assert args[6:15] == (0.3, cuda_build.DTYPE_CODE[dtype], n, d1, d2, v, k,
                          *pt.split_plan(n, v))
    assert args[17:] == (vals.data_ptr(), ids.data_ptr(), 0)
    assert pt.project2_logp_topk.launches == before + 1


@pytest.mark.parametrize("n_frames,n_mel", [(1, 40), (998, 80), (4096, 128)])
def test_kernel3_launch_arguments(kernel_stub, n_frames, n_mel):
    """Kernel 3 gets the frames, the mel matrix, the twiddle table and the
    mel ranges where they lie, with the transform's sizes, and writes the
    f32[F, M] it returns."""
    frames, mel_t, tw, ranges = _frames(n_frames, n_mel)
    before = fk.spec_mel.launches
    out = fk._spec_mel_cuda(frames, mel_t, tw, ranges)
    ((name, args),) = kernel_stub.calls
    assert name == "fbank_spec_mel_launch"
    assert args == (frames.data_ptr(), mel_t.data_ptr(), tw.data_ptr(), ranges.data_ptr(),
                    n_frames, 400, 512, 257, n_mel, out.data_ptr(), 0)
    assert out.shape == (n_frames, n_mel) and out.dtype == torch.float32
    assert fk.spec_mel.launches == before + 1


def test_empty_inputs_launch_nothing(kernel_stub):
    h, w, b = _head(0, 64, 300, torch.float32, True)
    vals, ids, lse = pt._project_logp_topk_cuda(h, w, b, 5)
    assert vals.shape == (0, 5) and lse.shape == (0,)
    vals, ids = pt._project2_logp_topk_cuda(h, w, b, h, w, None, 0.1, 5)
    assert ids.shape == (0, 5)
    _, mel_t, tw, ranges = _frames(1)
    assert fk._spec_mel_cuda(torch.zeros(0, 400), mel_t, tw, ranges).shape == (0, 40)
    assert kernel_stub.calls == []


def _kernel1(k=5, v=300, **change):
    h, w, b = _head(4, 64, v, torch.float32, True)
    args = dict(h=h, weight=w, bias=b, k=k)
    args.update(change)
    return lambda: pt._project_logp_topk_cuda(**args)


def _kernel2(k=5, **change):
    h1, w1, b1 = _head(4, 64, 300, torch.float32, True)
    h2, w2, b2 = _head(4, 32, 300, torch.float32, False, seed=5)
    args = dict(h1=h1, w1=w1, b1=b1, h2=h2, w2=w2, b2=b2, lam=0.1, k=k)
    args.update(change)
    return lambda: pt._project2_logp_topk_cuda(**args)


def _kernel3(**change):
    frames, mel_t, tw, ranges = _frames(8)
    args = dict(frames=frames, mel_t=mel_t, twiddle=tw, ranges=ranges)
    args.update(change)
    return lambda: fk._spec_mel_cuda(**args)


REFUSALS = [
    ("kernel 1: k 0", lambda: _kernel1(k=0), ValueError),
    ("kernel 1: k past 128", lambda: _kernel1(k=129, v=4233), ValueError),
    ("kernel 1: k past V", lambda: _kernel1(k=40, v=32), ValueError),
    ("kernel 1: float16 h", lambda: _kernel1(h=_normal(4, 64, dtype=torch.float16)), TypeError),
    ("kernel 1: weight of another width", lambda: _kernel1(weight=_normal(300, 32)), ValueError),
    ("kernel 1: strided h", lambda: _kernel1(h=_normal(64, 4).T), ValueError),
    ("kernel 2: k past 128", lambda: _kernel2(k=129), ValueError),
    ("kernel 2: heads of other rows", lambda: _kernel2(h2=_normal(5, 32)), ValueError),
    ("kernel 2: heads of other vocabularies",
     lambda: _kernel2(w2=_normal(301, 32), b2=None), ValueError),
    ("kernel 2: heads of other types",
     lambda: _kernel2(h2=_normal(4, 32, dtype=torch.bfloat16)), TypeError),
    ("kernel 3: frames off 16 bytes",
     lambda: _kernel3(frames=torch.zeros(8 * 400 + 1)[1:].view(8, 400)), ValueError),
    ("kernel 3: float64 frames", lambda: _kernel3(frames=_normal(8, 400).double()), TypeError),
    ("kernel 3: a window not a multiple of 4", lambda: _kernel3(frames=_normal(8, 398)),
     ValueError),
    ("kernel 3: a 256-point twiddle table", lambda: _kernel3(twiddle=torch.zeros(256, 2)),
     ValueError),
    ("kernel 3: int64 mel ranges",
     lambda: _kernel3(ranges=torch.zeros(40, 3, dtype=torch.int64)), ValueError),
]


@pytest.mark.parametrize("name,call,error", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_kernels_1_to_3_refuse_what_they_do_not_take(kernel_stub, name, call, error):
    launches = (pt.project_logp_topk.launches, pt.project2_logp_topk.launches,
                fk.spec_mel.launches)
    with pytest.raises(error):
        call()()
    assert kernel_stub.calls == []
    assert launches == (pt.project_logp_topk.launches, pt.project2_logp_topk.launches,
                        fk.spec_mel.launches)


def _beam_cross():
    k, v = torch.zeros(2, 2, 4, 7, 64, dtype=torch.bfloat16).unbind(0)
    q = torch.zeros(6, 4, 64, dtype=torch.bfloat16)
    return lambda: ba._cross_cuda(q, k, v, None, torch.bfloat16), ba.beam_cross_attention


def _beam_self():
    cache_k, cache_v = torch.zeros(2, 6, 4, 9, 64, dtype=torch.bfloat16).unbind(0)
    q, k_t, v_t = torch.zeros(3, 6, 4, 64, dtype=torch.bfloat16).unbind(0)
    src = torch.arange(3)[None, :, None].expand(2, 3, 9).contiguous()
    return (lambda: ba._self_cuda(q, k_t, v_t, cache_k, cache_v, 0, src),
            ba.beam_self_attention)


def _encoder():
    q, k, v = torch.zeros(3, 2, 4, 12, 64, dtype=torch.bfloat16).unbind(0)
    return lambda: ea._cuda(q, k, v, None), ea.encoder_self_attention


ENTRIES = [
    ("project_topk", lambda: (_kernel1(), pt.project_logp_topk)),
    ("project2_topk", lambda: (_kernel2(), pt.project2_logp_topk)),
    ("fbank_spec_mel", lambda: (_kernel3(), fk.spec_mel)),
    ("beam_attention_cross", _beam_cross),
    ("beam_attention_self", _beam_self),
    ("encoder_attention", _encoder),
]


@pytest.mark.parametrize("name,make", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_a_failed_launch_raises_with_the_librarys_own_string(kernel_stub, name, make):
    """Every wrapper launches through the seam: a non-zero return raises
    ``RuntimeError`` with ``<lib>_error_string`` of the code and the code,
    and is not counted as a launch."""
    call, counted = make()
    kernel_stub.code = 700
    before = counted.launches
    with pytest.raises(RuntimeError, match=r"_launch failed: stub error 700 \(700\)"):
        call()
    assert counted.launches == before and len(kernel_stub.calls) == 1
    assert kernel_stub.calls[0][0].startswith(name)
    kernel_stub.code = 0
    call()
    assert counted.launches == before + 1


def test_an_entry_binds_each_loaded_library_once(monkeypatch):
    """The library is taken from ``load`` at every call: its entry's types
    are set at its first call, and a library loaded anew (the ablation
    tools clear ``_loaded`` and load a rebuilt one) is bound at its own
    first call, so every launch goes to the library loaded now."""
    monkeypatch.setattr(cuda_build, "launch", lambda fn, index, args: fn(*args, 0))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    first, second = StubLibrary(), StubLibrary()
    entry = cuda_build.Entry("demo", "demo_launch", "pilf")
    cuda_build._loaded["demo"] = first
    entry(0, None, 1, 2, 0.5)
    assert first.demo_launch.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_float, ctypes.c_void_p]
    assert first.demo_launch.restype is ctypes.c_int
    assert first.demo_error_string.restype is ctypes.c_char_p
    first.demo_launch.argtypes = marker = list(first.demo_launch.argtypes)
    entry(0, 7, 1, 2, 0.5)
    assert first.demo_launch.argtypes is marker  # not set again
    cuda_build._loaded.clear()
    cuda_build._loaded["demo"] = second
    entry(0, 8, 1, 2, 0.5)
    assert [c[1][0] for c in first.calls] == [None, 7] and second.calls == [("demo_launch",
                                                                            (8, 1, 2, 0.5, 0))]
    assert second.demo_launch.argtypes == first.demo_launch.argtypes


@pytest.mark.parametrize("dtype,shape,strides,offset,ok", [
    (torch.float32, (4, 8), (8, 1), 0, True), (torch.float32, (4, 6), (6, 1), 0, False),
    (torch.bfloat16, (4, 8), (8, 1), 0, True), (torch.bfloat16, (4, 8), (12, 1), 0, False),
    (torch.bfloat16, (4, 8), (8, 1), 8, True), (torch.bfloat16, (4, 8), (8, 1), 4, False),
    (torch.float32, (4, 8), (1, 4), 0, False)])
def test_the_16_byte_row_rule(dtype, shape, strides, offset, ok):
    """Rows start on 16 bytes: unit innermost stride, a 16-byte address and
    every other stride a whole number of 16-byte vectors."""
    t = torch.zeros(128, dtype=dtype)[offset:].as_strided(shape, strides)
    assert cuda_build.rows_aligned(t) is ok
    assert cuda_build.rows_aligned(torch.zeros(4, 8, dtype=dtype), t) is ok
