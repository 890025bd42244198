"""Self-attention at inference (``ops/encoder_attention.py``, kernel 5) on the CPU.

On a CPU tensor ``encoder_self_attention`` runs its plain PyTorch version,
which has to be ``attention_context``'s composition as it was before the
kernel, bit for bit: ``old_attention_context`` below is that code, kept here
as the reference. ``attention_context`` hands a call to the kernel only where
``takes`` says so; that rule and the wrapper's host side (the launch
arguments, the output layout) run here with the built library stubbed
(``torch_kernel_stub.py``, shared with kernels 1-4). The kernel itself runs
only on the card (``tests/test_torch_port_gpu.py``).
"""

import math

import pytest
import torch

from opentransformer_tpu_torch.models import modules
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.ops import encoder_attention as ea
from opentransformer_tpu_torch.ops.masks import apply_attn_mask, causal_mask, chunk_attn_mask
from torch_kernel_stub import kernel_stub  # noqa: F401 (a fixture)


def old_attention_context(q, k, v, mask):
    """``modules.attention_context`` before kernel 5, as it was."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    weights = torch.softmax(apply_attn_mask(scores, mask), dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def qkv(b, h, t_q, t_k, dh, dtype=torch.bfloat16, seed=0):
    """q, k, v as the encoder hands them over: head splits of one fused
    projection's output (q from a projection of T_q positions when T_q ≠ T_k)."""
    g = torch.Generator().manual_seed(seed)

    def split(t):
        return [modules.split_heads(a, h) for a in
                torch.randn(b, t, 3 * h * dh, generator=g).to(dtype).chunk(3, dim=-1)]

    q, k, v = split(t_q)
    if t_k != t_q:
        _, k, v = split(t_k)
    return q, k, v


def key_mask(kind, b, t_k):
    if kind is None:
        return None
    keep = torch.ones(b, t_k, dtype=torch.bool)
    keep[::2, 2 * t_k // 3:] = False
    if kind == "empty row":
        keep[1] = False
    return keep[:, None, None, :]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask", [None, "padding", "empty row"])
@pytest.mark.parametrize("t_q,t_k", [(19, 19), (5, 23)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_plain_equals_the_replaced_composition(dh, t_q, t_k, mask, dtype):
    q, k, v = qkv(3, 2, t_q, t_k, dh, dtype, seed=dh + t_q)
    m = key_mask(mask, 3, t_k)
    want = old_attention_context(q, k, v, m)
    got = ea.encoder_self_attention(q, k, v, m)
    assert got.dtype == dtype and got.shape == (3, 2, t_q, dh)
    assert torch.equal(got, want)
    assert torch.equal(modules.attention_context(q, k, v, m), want)


@pytest.fixture
def on_card(monkeypatch, kernel_stub):
    """The CUDA path's host side on CPU tensors: tensors count as on the
    card, and the kernel library is the shared stub."""
    monkeypatch.setattr(ea, "_on_card", lambda t: True)
    return kernel_stub


def _cases():
    """(name, inputs, grad, whether the kernel takes the call)."""
    b, h, t, dh = 2, 4, 12, 64
    pad = key_mask("padding", b, t)
    return [
        ("key padding", (b, h, t, t, dh, torch.bfloat16), pad, False, True),
        ("no mask", (b, h, t, t, dh, torch.bfloat16), None, False, True),
        ("a mask shared by the rows", (b, h, t, t, dh, torch.bfloat16), pad[:1], False, True),
        ("a mask of the keys alone", (b, h, t, t, dh, torch.bfloat16), pad[0, 0, 0], False, True),
        ("T_q != T_k", (b, h, 1, t, dh, torch.bfloat16), pad, False, True),
        ("Dh 32", (b, h, t, t, 32, torch.bfloat16), pad, False, True),
        ("Dh 128", (b, h, t, t, 128, torch.bfloat16), pad, False, True),
        ("grad on, inputs that require it", (b, h, t, t, dh, torch.bfloat16), pad, True, False),
        ("float32", (b, h, t, t, dh, torch.float32), pad, False, False),
        ("causal", (b, h, t, t, dh, torch.bfloat16), causal_mask(t), False, False),
        ("chunked", (b, h, t, t, dh, torch.bfloat16), chunk_attn_mask(t, 4, 1), False, False),
        ("padding and chunks", (b, h, t, t, dh, torch.bfloat16),
         pad & chunk_attn_mask(t, 4, 1), False, False),
        ("a mask per head", (b, h, t, t, dh, torch.bfloat16),
         pad.expand(b, h, 1, t).clone(), False, False),
        ("Dh 96", (b, h, t, t, 96, torch.bfloat16), pad, False, False),
        ("float16", (b, h, t, t, dh, torch.float16), pad, False, False),
    ]


@pytest.mark.parametrize("name,shape,mask,grad,taken", _cases(), ids=[c[0] for c in _cases()])
def test_routing_rule(on_card, name, shape, mask, grad, taken):
    """``attention_context`` launches the kernel exactly where the rule
    takes the call, and keeps the composition (the same numbers as before)
    for training with autograd, float32 models, causal and chunk masks, a
    mask per head and head widths the kernel is not built for."""
    b, h, t_q, t_k, dh, dtype = shape
    q, k, v = qkv(b, h, t_q, t_k, dh, dtype)
    if grad:
        q.requires_grad_(True)
    assert ea.takes(q, k, v, mask) is taken
    out = modules.attention_context(q, k, v, mask)
    assert len(on_card.calls) == (1 if taken else 0)
    assert out.shape == (b, h, t_q, dh)
    if not taken:
        assert torch.equal(out, old_attention_context(q, k, v, mask))
    with torch.no_grad():  # the same inputs with grad mode off: no gradient can flow
        assert ea.takes(q, k, v, mask) is (taken or (grad and name.startswith("grad")))


def test_grad_mode_on_without_inputs_that_require_grad_is_taken(on_card):
    q, k, v = qkv(2, 4, 8, 8, 64)
    assert torch.is_grad_enabled() and ea.takes(q, k, v, None)
    with torch.inference_mode():
        assert ea.takes(q, k, v, None)


def test_launch_arguments_and_output_layout(on_card):
    """The kernel reads q, k and v where the fused projection left them
    (the strides of its head splits), the key mask a byte per key ([B, T]
    behind [B, 1, 1, T]; a shared mask with a row stride of 0) and writes
    [B, T_q, H, Dh] storage, returned as the [B, H, T_q, Dh] view that
    ``merge_heads`` reshapes without a copy."""
    b, h, t, dh = 3, 4, 10, 64
    q, k, v = qkv(b, h, t, t, dh)
    pad = key_mask("padding", b, t)
    out = ea.encoder_self_attention(q, k, v, pad)
    ((name, args),) = on_card.calls
    assert name == "encoder_attention_launch"
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    assert qs == (t * 3 * h * dh, dh, 3 * h * dh, 1)
    assert args[:12] == (q.data_ptr(), qs[0], qs[1], qs[2], k.data_ptr(), ks[0], ks[1], ks[2],
                         v.data_ptr(), vs[0], vs[1], vs[2])
    assert args[12:15] == (pad.data_ptr(), t, 1)
    assert args[16:] == (b, h, t, t, dh, 0)
    assert out.shape == (b, h, t, dh) and out.dtype == torch.bfloat16
    assert args[15] == out.data_ptr()
    assert out.transpose(1, 2).is_contiguous()
    merged = modules.merge_heads(out)
    assert merged.shape == (b, t, h * dh) and merged.data_ptr() == out.data_ptr()
    assert merged._base is not None  # a view, not a copy
    ea.encoder_self_attention(q, k, v, pad[:1])
    assert on_card.calls[-1][1][12:15] == (pad.data_ptr(), 0, 1)
    ea.encoder_self_attention(q, k, v, None)
    assert on_card.calls[-1][1][12:15] == (None, 0, 0)


def test_the_wrapper_refuses_what_the_kernel_does_not_take(on_card):
    q, k, v = qkv(2, 4, 8, 8, 64)
    with pytest.raises(TypeError):
        ea.encoder_self_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ea.encoder_self_attention(q, k.float(), v.float())
    with pytest.raises(ValueError):  # Dh the kernel is not built for
        qq, kk, vv = qkv(2, 4, 8, 8, 96)
        ea.encoder_self_attention(qq, kk, vv)
    with pytest.raises(ValueError):  # Dh not innermost
        ea.encoder_self_attention(q, k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):  # rows off 16 bytes
        odd = torch.zeros(2 * 4 * 8 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 8, 64)
        ea.encoder_self_attention(odd, k, v)
    with pytest.raises(ValueError):  # not a key-only mask
        ea.encoder_self_attention(q, k, v, causal_mask(8))
    with pytest.raises(ValueError):
        ea.encoder_self_attention(q, k, v, key_mask("padding", 2, 8).int())
    assert on_card.calls == []


@pytest.mark.parametrize("shape,ok", [((2, 1, 1, 9), True), ((1, 1, 1, 9), True), ((9,), True),
                                      ((2, 9), False), ((2, 4, 1, 9), False),
                                      ((2, 1, 5, 9), False), ((3, 1, 1, 9), False),
                                      ((2, 1, 1, 1), False)])
def test_key_only_masks(shape, ok):
    assert ea._key_only(torch.ones(shape, dtype=torch.bool), 2, 9) is ok


SMALL_WHISPER = {
    "type": "speech2text", "frontend_type": "whisper",
    "frontend": {"input_size": 16, "output_size": 64, "act_func_type": "gelu_erf"},
    "encoder_type": "transformer",
    "encoder": {"d_model": 64, "n_heads": 2, "d_ff": 128, "n_blocks": 3,
                "activation": "gelu_erf", "normalize_before": True,
                "pre_norm_residual": "input", "ln_eps": 1e-5, "pos_style": "whisper",
                "slf_attn_dropout": 0.0, "ffn_dropout": 0.0, "residual_dropout": 0.0,
                "pos_dropout": 0.0},
    "decoder": {"vocab_size": 50, "d_model": 64, "n_heads": 2, "d_ff": 128, "n_blocks": 2,
                "activation": "gelu_erf", "normalize_before": True,
                "pre_norm_residual": "input", "ln_eps": 1e-5, "share_embedding": True,
                "pos_style": "learned", "max_positions": 16, "output_bias": False,
                "slf_attn_dropout": 0.0, "src_attn_dropout": 0.0, "ffn_dropout": 0.0,
                "residual_dropout": 0.0, "pos_dropout": 0.0}}


def test_encode_launches_once_per_block_at_inference_and_never_in_training(on_card):
    """A bf16 encode under ``inference_mode`` takes the kernel once per
    encoder block (Dh 32 here); the same model training (autograd on, its
    parameters requiring grad) keeps the composition."""
    torch.manual_seed(0)
    model = build_model(SMALL_WHISPER, device="cpu", dtype=torch.bfloat16)
    feats = torch.randn(2, 40, 16, dtype=torch.bfloat16)
    mask = torch.ones(2, 40, dtype=torch.bool)
    with torch.inference_mode():
        model.eval().encode(feats, mask)
    assert len(on_card.calls) == 3
    model.train()
    memory, _ = model.encode(feats, mask)
    assert memory.requires_grad and len(on_card.calls) == 3
