"""The beam step's attention wrappers (``ops/beam_attention.py``) on the CPU.

On a CPU tensor each entry runs its plain PyTorch version, which has to be
the decoder's code before the kernel, bit for bit: the two functions below
are that code, kept here as the reference. The kernel itself runs only on
the card (``tests/test_torch_port_gpu.py``); here its launch counters stay
0, and a beam search calls each entry once per block and step.
"""

import math

import numpy as np
import pytest
import torch

from opentransformer_tpu_torch.models import modules
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops import beam_attention as ba
from opentransformer_tpu_torch.ops import cuda_build
from opentransformer_tpu_torch.ops.masks import apply_attn_mask
from opentransformer_tpu_torch.recognize.base import make_memory_search
from torch_kernel_stub import kernel_stub  # noqa: F401 (a fixture)


def old_attend_beamed_context(q, k, v, key_pad_mask, dtype):
    """``MultiHeadCrossAttention.attend_beamed`` between q_proj and
    out_proj, as it was: q [B·K, H, 1, Dh] → [B·K, 1, H·Dh]."""
    b, bk = k.shape[0], q.shape[0]
    beams, h, dk = bk // b, q.shape[1], q.shape[-1]
    q = q.reshape(b, beams, h, dk).float()
    scores = torch.einsum("bkhd,bhtd->bkht", q, k.float()) / math.sqrt(dk)
    if key_pad_mask is not None:
        scores = apply_attn_mask(scores, key_pad_mask[:, None, None, :])
    weights = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bkht,bhtd->bkhd", weights.float(), v.float()).to(dtype)
    return ctx.reshape(bk, 1, h * dk)


def old_ancestral_decode_context(q, cache_k, cache_v, index, src):
    """The removed ``modules.ancestral_decode_context``, as it was."""
    b, kk, _ = src.shape
    h, dk = q.shape[1], q.shape[3]
    u = index + 1
    qb = q.reshape(b, kk, h, dk).float()
    ck = cache_k.reshape(b, kk, h, -1, dk)
    cv = cache_v.reshape(b, kk, h, -1, dk)
    bi = torch.arange(b)[:, None, None]
    ui = torch.arange(u)[None, None, :]
    rows = src[:, :, :u]
    keys = ck[bi, rows, :, ui]
    vals = cv[bi, rows, :, ui]
    scores = torch.einsum("bkhd,bkuhd->bkhu", qb, keys.float()) / math.sqrt(dk)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkhu,bkuhd->bkhd", weights.float(), vals.float()).to(q.dtype)
    return ctx.reshape(b * kk, h, 1, dk)


def _normal(rng, *shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def lineages(rng, b, k, u_max, index):
    """int64 [B, K, U_max] as a beam search leaves it: each slot's lineage
    is a random parent's up to the last step, so lineages merge going back
    (shared rows), and the identity at ``index``."""
    src = np.tile(np.arange(k), (b, 1))[:, :, None].repeat(u_max, axis=2)
    for p in range(index):
        # every slot starts from slot 0 (the search's initial scores)
        parent = rng.integers(0, k, size=(b, k)) if p else np.zeros((b, k), np.int64)
        src = np.take_along_axis(src, parent[:, :, None].repeat(u_max, axis=2), axis=1)
        src[:, :, p + 1] = np.arange(k)
    return torch.from_numpy(src.astype(np.int64))


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 96])
@pytest.mark.parametrize("beams", [1, 5])
def test_cross_plain_equals_the_replaced_code(beams, dh, dtype):
    rng = np.random.default_rng(beams * 1000 + dh)
    b, h, t = 3, 2, 11
    # the layout attend_beamed receives: q a head split of q_proj's output,
    # k and v the halves of kv_proj's
    q = _normal(rng, b * beams, 1, h * dh, dtype=dtype)
    q = modules.split_heads(q, h)
    k, v = (modules.split_heads(a, h) for a in
            _normal(rng, b, t, 2 * h * dh, dtype=dtype).chunk(2, dim=-1))
    mask = torch.arange(t)[None] < torch.tensor([t, 7, 1])[:, None]
    for m in (mask, None):
        ref = old_attend_beamed_context(q, k, v, m, dtype)
        got = ba.beam_cross_attention(q[:, :, 0], k, v, m, dtype)
        assert got.dtype == dtype and got.shape == (b * beams, h, dh)
        assert torch.equal(got.reshape(b * beams, 1, h * dh), ref)


@pytest.mark.parametrize("index", [0, 6])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64, 96])
@pytest.mark.parametrize("beams", [1, 5])
def test_self_plain_equals_the_replaced_code(beams, dh, dtype, index):
    rng = np.random.default_rng(beams * 1000 + dh + index)
    b, h, u_max = 2, 3, 9
    n = b * beams
    qkv = _normal(rng, n, 1, 3 * h * dh, dtype=dtype)
    q, k_t, v_t = (modules.split_heads(a, h) for a in qkv.chunk(3, dim=-1))
    cache_k = _normal(rng, n, h, u_max, dh, dtype=dtype)
    cache_v = _normal(rng, n, h, u_max, dh, dtype=dtype)
    src = lineages(rng, b, beams, u_max, index)
    if beams > 1 and index > 0:
        assert (src[:, :, 0] == src[:, :1, 0]).all()  # every lineage shares the first row
    ref_k, ref_v = cache_k.clone(), cache_v.clone()
    ref_k[:, :, index] = k_t[:, :, 0].to(ref_k.dtype)
    ref_v[:, :, index] = v_t[:, :, 0].to(ref_v.dtype)
    ref = old_ancestral_decode_context(q, ref_k.to(q.dtype), ref_v.to(q.dtype), index, src)
    got = ba.beam_self_attention(q[:, :, 0], k_t[:, :, 0], v_t[:, :, 0], cache_k, cache_v,
                                 index, src)
    assert got.dtype == dtype and got.shape == (n, h, dh)
    assert torch.equal(got, ref[:, :, 0])
    assert torch.equal(cache_k, ref_k) and torch.equal(cache_v, ref_v)


SMALL_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 20, "output_size": 32, "mid_channel": 4, "out_channel": 8},
    "encoder": {"d_model": 32, "n_heads": 4, "d_ff": 48, "n_blocks": 2, "activation": "glu"},
    "decoder": {"vocab_size": 40, "d_model": 32, "n_heads": 4, "d_ff": 48, "memory_dim": 32,
                "n_blocks": 2, "activation": "glu", "share_embedding": False}}


def _memory(model, b=3, t=40):
    torch.manual_seed(0)
    feats = torch.randn(b, t, 20)
    mask = torch.arange(t)[None] < torch.tensor([t, 31, 17])[:, None]
    with torch.inference_mode():
        return model.encode(feats, mask)


def test_cpu_search_launches_no_kernel():
    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device="cpu")
    memory, memory_mask = _memory(model)
    before = ba.beam_cross_attention.launches, ba.beam_self_attention.launches
    hyp = make_memory_search(model, 3, 6, eos_id=-1)(memory, memory_mask)
    assert hyp.tokens.shape == (3, 3, 7)
    assert (ba.beam_cross_attention.launches, ba.beam_self_attention.launches) == before == (0, 0)


@pytest.mark.parametrize("beam,steps", [(4, 6), (1, 5)])
def test_search_calls_each_entry_once_per_block_and_step(monkeypatch, beam, steps):
    """A beam search of a 2-block decoder: the cross entry once per block
    and step, the self entry too (greedy keeps the in-order cache: none)."""
    torch.manual_seed(0)
    model = build_model(SMALL_CFG, device="cpu")
    memory, memory_mask = _memory(model)
    calls = {"cross": 0, "self": 0}

    def counting(name, fn):
        def stub(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return stub

    monkeypatch.setattr(modules, "beam_cross_attention",
                        counting("cross", ba.beam_cross_attention))
    monkeypatch.setattr(modules, "beam_self_attention",
                        counting("self", ba.beam_self_attention))
    make_memory_search(model, beam, steps, eos_id=-1)(memory, memory_mask)
    blocks = len(model.decoder.layers)
    assert blocks == 2
    assert calls == {"cross": blocks * steps, "self": blocks * steps if beam > 1 else 0}


@pytest.mark.parametrize("beams,plan", [(1, (1, 1)), (5, (1, 5)), (8, (1, 8)), (9, (2, 5)),
                                        (12, (2, 6)), (17, (3, 6))])
def test_beam_plan_splits_wide_beams_evenly(beams, plan):
    chunks, kc = ba.beam_plan(beams)
    assert (chunks, kc) == plan
    assert kc <= ba.MAX_BEAMS and (chunks - 1) * kc < beams <= chunks * kc


@pytest.mark.parametrize("dtype,dh,ok", [(torch.bfloat16, 64, True), (torch.float32, 32, True),
                                         (torch.float32, 36, True), (torch.bfloat16, 36, False)])
def test_the_kernels_layout_rule_takes_the_decoders_views(dtype, dh, ok):
    """The kernel's 16-byte row loads: the views the decoder hands over
    (head splits of one projection, the halves of kv_proj) pass where a row
    of Dh elements is a whole number of 16-byte vectors; a view that starts
    inside a row or is not innermost along Dh does not."""
    h = 4
    q, k_t, v_t = torch.zeros(6, 1, 3 * h * dh, dtype=dtype).view(6, 3, h, dh).unbind(1)
    k, v = (modules.split_heads(a, h) for a in
            torch.zeros(2, 7, 2 * h * dh, dtype=dtype).chunk(2, dim=-1))
    aligned = cuda_build.rows_aligned
    assert aligned(q, k_t, v_t) is ok and aligned(q, k, v) is ok
    assert not aligned(q[..., 1:])
    assert not aligned(k.transpose(2, 3))


@pytest.mark.parametrize("kc,n_pos,slots", [(5, 1024, None), (5, 1025, 8), (1, 8192, None),
                                            (3, 4000, 4)])
def test_scores_go_to_device_memory_past_the_on_chip_budget(kc, n_pos, slots):
    """A block's scores are [n_pos][P], P its beams rounded up to a power of
    two, on chip up to SCORES_ON_CHIP_BYTES; past it, a scratch buffer of
    every block's."""
    got = ba._scratch(6, kc, n_pos, torch.device("cpu"))
    if slots is None:
        assert got is None
    else:
        assert got.dtype == torch.float32 and got.numel() == 6 * slots * n_pos


def _counting(monkeypatch, name):
    built = []
    fn = getattr(ba, name)

    def counted(*args):
        built.append(args)
        return fn(*args)

    monkeypatch.setattr(ba, name, counted)
    return built


def test_cross_entry_checks_the_caches_once_a_search(monkeypatch, kernel_stub):
    """The cross keys and values, the mask and the output type are checked
    once and their launch arguments kept on ``k``: twelve calls with the same
    tensors build one plan and launch twelve times with the arguments the
    kernel's C entry takes (bf16 in and out: the one-pass entry); a new value
    tensor, mask, output type or q shape checks again (a float32 output: the
    two-pass entry, with its type codes and no scratch at 11 frames)."""
    built = _counting(monkeypatch, "_cross_plan")
    b, beams, h, dh, t = 3, 5, 4, 64, 11
    k, v = (modules.split_heads(a, h) for a in
            torch.zeros(b, t, 2 * h * dh, dtype=torch.bfloat16).chunk(2, dim=-1))
    mask = torch.ones(b, t, dtype=torch.bool)
    for _ in range(12):
        q = torch.zeros(b * beams, 1, 3 * h * dh, dtype=torch.bfloat16).view(
            b * beams, 3, h, dh)[:, 0]
        out = ba._cross_cuda(q, k, v, mask, torch.bfloat16)
        assert out.shape == (b * beams, h, dh) and out.dtype == torch.bfloat16
    assert len(built) == 1 and len(kernel_stub.calls) == 12
    name, args = kernel_stub.calls[-1]
    ks = k.stride()
    assert name == "beam_attention_cross_online_launch" and args == (
        q.data_ptr(), 3 * h * dh, dh, k.data_ptr(), v.data_ptr(), ks[0], ks[1], ks[2],
        mask.data_ptr(), t, 1, b, beams, h, t, dh, 5, 1, out.data_ptr(), 0)
    ba._cross_cuda(q, k, torch.empty_strided(v.shape, v.stride(), dtype=v.dtype), mask,
                   torch.bfloat16)
    ba._cross_cuda(q, k, v, mask.clone(), torch.bfloat16)
    out = ba._cross_cuda(q, k, v, mask, torch.float32)
    assert kernel_stub.calls[-1] == ("beam_attention_cross_launch", (
        q.data_ptr(), 3 * h * dh, dh, k.data_ptr(), v.data_ptr(), ks[0], ks[1], ks[2],
        mask.data_ptr(), t, 1, b, beams, h, t, dh, 1, 0, 5, 1, None, out.data_ptr(), 0))
    ba._cross_cuda(q[: 2 * b], k, v, mask, torch.float32)
    assert len(built) == 5
    # q is checked at every call: rows that do not start on 16 bytes raise
    odd = torch.zeros(2 * b * h * dh + 1, dtype=torch.bfloat16)[1:].view(2 * b, h, dh)
    with pytest.raises(ValueError):
        ba._cross_cuda(odd, k, v, mask, torch.float32)
    assert len(built) == 5


def test_self_entry_checks_the_caches_once_and_the_step_at_every_call(monkeypatch, kernel_stub):
    built = _counting(monkeypatch, "_self_plan")
    b, beams, h, dh, u_max = 2, 5, 4, 64, 9
    n = b * beams
    cache_k = torch.zeros(n, h, u_max, dh, dtype=torch.bfloat16)
    cache_v = torch.zeros_like(cache_k)
    rng = np.random.default_rng(0)
    for index in range(u_max):
        q, k_t, v_t = torch.zeros(n, 3 * h * dh, dtype=torch.bfloat16).view(n, 3, h, dh).unbind(1)
        src = lineages(rng, b, beams, u_max, index)
        out = ba._self_cuda(q, k_t, v_t, cache_k, cache_v, index, src)
        assert out.shape == (n, h, dh)
    assert len(built) == 1 and len(kernel_stub.calls) == u_max
    name, args = kernel_stub.calls[-1]
    assert name == "beam_attention_self_launch" and args == (
        q.data_ptr(), 3 * h * dh, dh, k_t.data_ptr(), v_t.data_ptr(), 3 * h * dh, dh,
        cache_k.data_ptr(), cache_v.data_ptr(), src.data_ptr(), u_max, u_max - 1, u_max, b,
        beams, h, dh, 1, 5, 1, None, out.data_ptr(), 0)
    with pytest.raises(ValueError):  # index past the caches
        ba._self_cuda(q, k_t, v_t, cache_k, cache_v, u_max, src)
    with pytest.raises(ValueError):  # src of another batch
        ba._self_cuda(q, k_t, v_t, cache_k, cache_v, 1, src[:1].repeat(3, 1, 1))
    with pytest.raises(ValueError):  # the step's value off 16 bytes
        odd = torch.zeros(n * 3 * h * dh, dtype=torch.bfloat16)[1:].as_strided(
            (n, h, dh), k_t.stride())
        ba._self_cuda(q, k_t, odd, cache_k, cache_v, 1, src)
    with pytest.raises(TypeError):
        ba._self_cuda(q, k_t, v_t.float(), cache_k, cache_v, 1, src)
    assert len(built) == 1
    ba._self_cuda(q, k_t, v_t, cache_k, cache_v.clone(), 1, src)
    assert len(built) == 2


def test_the_stream_handle_is_looked_up_once():
    """The raw stream binding is taken where torch has it (a CUDA build;
    the card test asserts it is there); a torch without it takes
    ``torch.cuda.current_stream``."""
    from types import SimpleNamespace

    def raw(index):
        return index

    assert cuda_build.stream_getter(SimpleNamespace(_cuda_getCurrentRawStream=raw)) is raw
    fallback = cuda_build.stream_getter(SimpleNamespace())
    assert fallback is not raw and callable(fallback)
    expected = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    assert (cuda_build.current_stream is expected) == (expected is not None)
