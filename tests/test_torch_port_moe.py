"""The port's mixture of experts against the JAX package, on the CPU.

One case for each case of ``tests/test_moe.py`` (but the two that train on
an expert-parallel mesh): one expert is the dense FFN, dropped tokens pass
zero, top-2 gates and gradients, the top-1 router's gradient from the task
loss, ``scan_layers`` and ``moe_every``, the conformer's MoE, pads out of
capacity, the MoE LM's loss and aux and its cached decode. Then: the
routing itself (every choice's expert, kept or dropped, and each expert's
count) read from JAX's own computation (``tools/torch_port_moe_parity.py``),
streamed MoE encoders against the offline encode, the transducer's loss, one
Trainer update, the parameter layouts, the reference ``.pt`` refusal, the
two warnings, the router jitter, and the training CLI with ``moe_aux`` in
its history, a checkpoint average and ``--ep``.

The module runs PyTorch on one thread (the suite runs several test
processes at once), and each JAX model once, jitted, for every test that
reads it (a module-scoped fixture). Small models (d16-32, 2 blocks, 2-4
experts), weights from ``chip_smoke.seeded_params`` (numpy) in both
packages, inputs from numpy seeds, every dropout and jitter 0 where the
packages are compared. Tolerances: outputs, losses and aux within 1e-5
relative (float32 sums in other orders), gradients 1e-5 relative to their
tensor's scale, routing, kept masks and counts exactly.
"""

import copy
import importlib.util
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu import compat as jax_compat
from opentransformer_tpu.models import encoder as jax_encoder
from opentransformer_tpu.models.modules import MoEFeedForward as JaxMoE
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.train.trainer import Trainer as JaxTrainer
from opentransformer_tpu.train.trainer import default_speech_batch
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import average as average_cli
from opentransformer_tpu_torch.cli import run as run_cli
from opentransformer_tpu_torch.data.loader import collate_speech
from opentransformer_tpu_torch.models import encoder
from opentransformer_tpu_torch.models.modules import (
    MoEFeedForward,
    PositionwiseFeedForward,
    set_dropout_generator,
)
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize.base import make_memory_search
from opentransformer_tpu_torch.recognize.online import StreamingEncoderSession
from opentransformer_tpu_torch.train.checkpoint import Checkpointer
from opentransformer_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from test_torch_port_train import TRAIN_CFG, flat  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "torch_port_moe_parity", os.path.join(REPO, "tools", "torch_port_moe_parity.py"))
parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(parity)

RTOL = 1e-5
F_IN, D, V = 12, 32, 40
FRONT = {"input_size": F_IN, "output_size": D, "mid_channel": 4, "out_channel": 8}
MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.25, "moe_every": 2}
# chunked attention, so that the same model streams; capacity binds at 1.25
TRANSFORMER = {"d_model": D, "n_heads": 2, "d_ff": 48, "n_blocks": 2, "residual_dropout": 0.0,
               "activation": "glu", "chunk_size": 4, "left_chunks": 2, **MOE}
# a streamable conformer, drop-free at capacity 2.0 = E / k
CONFORMER = {"d_model": D, "n_heads": 2, "d_ff": 48, "nblocks": 2, "cov_kernel_size": 5,
             "residual_dropout": 0.0, "chunk_size": 4, "left_chunks": 2, "conv_causal": True,
             "relative_positional": False, **MOE, "moe_capacity_factor": 2.0}
DECODER = {"vocab_size": V, "d_model": D, "n_heads": 2, "d_ff": 48, "memory_dim": D,
           "n_blocks": 1, "residual_dropout": 0.0, "activation": "glu"}
CFGS = {
    "speech2text": {"type": "speech2text", "frontend_type": "conv", "frontend": FRONT,
                    "encoder_type": "transformer", "encoder": TRANSFORMER, "decoder": DECODER,
                    "moe_aux_weight": 0.05},
    "scan_layers": {"type": "ctc", "frontend_type": "conv", "frontend": FRONT,
                    "encoder_type": "transformer", "vocab_size": V,
                    "encoder": dict(TRANSFORMER, moe_experts=2, moe_top_k=1, moe_every=1,
                                    scan_layers=True)},
    "conformer": {"type": "ctc", "frontend_type": "conv", "frontend": FRONT,
                  "encoder_type": "conformer", "encoder": CONFORMER, "vocab_size": V},
    "transducer": {"type": "transducer", "frontend_type": "conv", "frontend": FRONT,
                   "encoder_type": "transformer", "encoder": TRANSFORMER, "vocab_size": V,
                   "predictor": {"num_layers": 1, "d_model": D, "dropout": 0.0}, "d_joint": 24,
                   "moe_aux_weight": 0.05},
}
LENS = {"speech2text": (61, 44, 23), "scan_layers": (40, 33), "conformer": (73, 73),
        "transducer": (52, 37)}
LM = {"type": "transformer_lm", "vocab_size": 20, "num_blocks": 2, "d_model": 32, "n_heads": 2,
      "d_ff": 64, "residual_dropout": 0.0, "moe_experts": 2, "moe_top_k": 2,
      "moe_aux_weight": 0.05}
TRAIN = dict(TRAIN_CFG, accum_steps=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def close_rel(got, want, rel=RTOL, key=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach().float()), want, rtol=0,
                               atol=rel * scale, err_msg=key)


def grad_tree(model):
    """The parameters' ``.grad`` in the JAX layout."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), clone.parameters()):
            q.copy_(p.grad)
    return compat.params_to_jax(clone)["params"]


def seeded(model, seed):
    """``model`` with seeded weights → (model, JAX-layout numpy params)."""
    params = chip_smoke.seeded_params(model, seed)
    return compat.load_into(model, params), params


def speech_batch(lens, seed=1):
    """A collated batch of ragged seeded utterances (the loader's format)."""
    rng = np.random.default_rng(seed)
    samples = []
    for i, n in enumerate(lens):
        y = [int(u) for u in rng.integers(3, V, size=int(rng.integers(2, 7)))]
        samples.append((f"u{i}", rng.normal(size=(n, F_IN)).astype(np.float32), n, y, len(y)))
    return collate_speech(samples)


class Pair:
    """A config in both packages with the same seeded weights, and JAX's
    loss, aux, encoder memory and gradients on one batch (one jitted call)."""

    def __init__(self, name, seed=0):
        self.cfg = CFGS[name]
        self.batch = speech_batch(LENS[name], seed + 1)
        self.args = default_speech_batch(self.batch)
        self.model, self.params = seeded(build_model(self.cfg, device="cpu"), seed)
        self.jm = jax_build_model(self.cfg)

        def both(m, *a):
            return m(*a), m.encode(a[0], a[1])

        def f(params):
            (loss, aux), (memory, _) = self.jm.apply({"params": params}, *self.args, method=both)
            return loss, (aux, memory)

        (loss, (aux, memory)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, self.params["params"]))
        self.loss, self.aux = float(loss), {k: float(v) for k, v in aux.items()}
        self.memory, self.grads = np.asarray(memory), np_tree(grads)

    def torch_args(self):
        return [torch.from_numpy(np.array(a)) for a in self.args]


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Pair(name)
        return cache[name]

    return get


def check_pair(pair):
    """The port's loss, aux, memory and every gradient against JAX's."""
    model = pair.model
    model.zero_grad()
    args = pair.torch_args()
    loss, aux = model(*args)
    loss.backward()
    close_rel(loss, pair.loss)
    assert sorted(aux) == sorted(pair.aux) and "moe_aux" in aux
    for key, value in pair.aux.items():
        close_rel(aux[key], value, key=key)
    with torch.no_grad():
        memory, _, moe_aux = model.encode(args[0], args[1], return_aux=True)
    close_rel(memory, pair.memory)
    close_rel(moe_aux, pair.aux["moe_aux"])
    got = flat(grad_tree(model))
    for key, want in flat(pair.grads).items():
        close_rel(got[key], want, key=key)
    return got


def moe_pair(d, ff, seed=0, **kw):
    """(JAX MoE, its params, the port's MoE with the same seeded weights)."""
    tm, params = seeded(MoEFeedForward(d, ff, **kw), seed)
    return JaxMoE(d, ff, **kw), params, tm


def run_both(jm, params, tm, x, mask=None):
    pm = None if mask is None else jnp.asarray(mask)
    want = jax.jit(lambda p, x: jm.apply(p, x, pad_mask=pm))(params, jnp.asarray(x))
    got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    return got, want


def force_expert_0(params, e):
    """A router that sends every token to expert 0."""
    d = params["params"]["router"]["dense"]["kernel"].shape[0]
    params["params"]["router"]["dense"]["kernel"] = np.zeros((d, e), np.float32)
    params["params"]["router"]["dense"]["bias"] = np.array([10.0] + [0.0] * (e - 1), np.float32)
    return params


# ----------------------------------------------------- tests/test_moe.py's cases
def test_single_expert_equals_dense_ffn():
    """One expert at capacity T: the port's MoE equals JAX's and the port's
    dense FFN with expert 0's weights; aux = 1."""
    x = np.random.default_rng(0).normal(size=(3, 12, 16)).astype(np.float32)
    jm, params, tm = moe_pair(16, 32, n_experts=1, top_k=1, capacity_factor=1.0,
                              activation="glu")
    (got, aux), (want, jaux) = run_both(jm, params, tm, x)
    close_rel(got, want)
    dense = PositionwiseFeedForward(16, 32, "glu")
    with torch.no_grad():
        dense.w1.weight.copy_(tm.w1[0].T)
        dense.w1.bias.copy_(tm.b1[0])
        dense.w2.weight.copy_(tm.w2[0].T)
        dense.w2.bias.copy_(tm.b2[0])
        close_rel(got, dense(torch.from_numpy(x)).numpy())
    close_rel(aux, float(jaux))
    assert abs(aux.item() - 1.0) <= 1e-6


def test_capacity_drops_pass_zero():
    """Every token to expert 0, capacity ceil(10·0.4/4) = 1: the first token
    is computed, the others pass zero, as in JAX."""
    x = np.random.default_rng(1).normal(size=(1, 10, 8)).astype(np.float32)
    jm, params, tm = moe_pair(8, 16, n_experts=4, top_k=1, capacity_factor=0.4)
    compat.load_into(tm, force_expert_0(params, 4))
    (got, _), (want, _) = run_both(jm, params, tm, x)
    close_rel(got, want)
    assert tm.capacity(10) == 1
    assert (got[0, :1].abs() > 0).all() and (got[0, 1:] == 0).all()


def test_top2_gates_and_grads():
    """Top-2: outputs, aux and the gradients of sum(y²) + 0.01·aux w.r.t.
    x, the router and the experts equal JAX's."""
    x = np.random.default_rng(2).normal(size=(2, 9, 12)).astype(np.float32)
    jm, params, tm = moe_pair(12, 24, seed=3, n_experts=4, top_k=2, capacity_factor=2.0)

    def loss_j(p, xj):
        y, aux = jm.apply(p, xj)
        return jnp.sum(y ** 2) + 0.01 * aux, y

    (_, y_j), (gj, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm(xt)
    (y.square().sum() + 0.01 * aux).backward()
    close_rel(y, y_j)
    close_rel(xt.grad, gx, key="x")
    for key, w in flat(np_tree(gj)["params"]).items():
        close_rel(flat(grad_tree(tm))[key], w, key=key)
    assert tm.router.weight.grad.abs().max() > 0


def test_top1_router_gets_main_loss_gradient():
    """Switch top-1 weighs by the raw router probability: the task loss
    alone reaches the router, with JAX's gradient."""
    x = np.random.default_rng(4).normal(size=(2, 9, 12)).astype(np.float32)
    jm, params, tm = moe_pair(12, 24, seed=5, n_experts=4, top_k=1, capacity_factor=2.0)
    g = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x))[0] ** 2)))(params)
    y, _ = tm(torch.from_numpy(x))
    y.square().sum().backward()
    want = np.asarray(g["params"]["router"]["dense"]["kernel"]).T
    assert np.abs(want).max() > 0
    close_rel(tm.router.weight.grad, want)


@pytest.mark.parametrize("layout", ["scan_layers", "speech2text"])
def test_moe_scan_layers_and_moe_every(pairs, layout):
    """``scan_layers`` stacks MoE blocks [L, E, ...] (every block MoE);
    ``moe_every: 2`` makes block 1 MoE and block 0 dense: the port's
    parameter tree has JAX's shapes, and loss, aux, memory and gradients
    equal JAX's. ``scan_layers`` with ``moe_every`` != 1 raises in both."""
    pair = pairs(layout)
    shapes = jax.eval_shape(lambda: pair.jm.init(jax.random.PRNGKey(0), *pair.args))
    want = {"/".join(k): v.shape for k, v in compat._flatten(shapes["params"])}
    assert {k: v.shape for k, v in flat(pair.params["params"]).items()} == want
    enc = pair.params["params"]["encoder"]
    if layout == "scan_layers":
        assert enc["blocks"]["moe"]["w1"].shape[:2] == (2, 2)
    else:
        assert "moe" in enc["block_1"] and "ffn" in enc["block_0"] and "moe" not in enc["block_0"]
    check_pair(pair)
    bad = dict(pair.cfg, encoder=dict(pair.cfg["encoder"], scan_layers=True, moe_every=2))
    with pytest.raises(ValueError, match="moe_every"):
        build_model(bad, device="cpu")
    with pytest.raises(ValueError, match="moe_every"):
        jax.eval_shape(lambda: jax_build_model(bad).init(jax.random.PRNGKey(0), *pair.args))


def test_conformer_moe(pairs):
    """The conformer's second macaron FFN as MoE (block 1 of 2; block 0
    keeps its dense ``post_ffn``): loss, ``moe_aux``, memory and every
    gradient equal JAX's; ``ref_compat`` with MoE raises in both."""
    pair = pairs("conformer")
    enc = pair.params["params"]["encoder"]
    assert "moe" in enc["block_1"] and "post_ffn" in enc["block_0"]
    assert "post_ffn" not in enc["block_1"] and "pre_ffn" in enc["block_1"]
    got = check_pair(pair)
    assert np.abs(got["encoder/block_1/moe/w1"]).max() > 0
    bad = dict(pair.cfg, encoder=dict(CONFORMER, ref_compat=True, moe_every=1))
    with pytest.raises(ValueError, match="ref_compat"):
        build_model(bad, device="cpu")
    with pytest.raises(ValueError, match="ref_compat"):
        jax.eval_shape(lambda: jax_build_model(bad).init(jax.random.PRNGKey(0), *pair.args))


def test_pad_mask_excludes_pads_from_capacity():
    """Pads ahead of the real tokens claim no capacity: with the mask every
    real token is kept, pads give zero, aux ≈ E; without it the real tokens
    are dropped. Both as in JAX."""
    x = np.random.default_rng(3).normal(size=(1, 8, 8)).astype(np.float32)
    jm, params, tm = moe_pair(8, 16, n_experts=2, top_k=1, capacity_factor=1.0)
    compat.load_into(tm, force_expert_0(params, 2))
    mask = np.array([[False] * 4 + [True] * 4])
    (got, _), (want, _) = run_both(jm, params, tm, x)
    close_rel(got, want)
    assert (got[0, 4:] == 0).all()
    (got, aux), (want, jaux) = run_both(jm, params, tm, x, mask)
    close_rel(got, want)
    close_rel(aux, float(jaux))
    assert (got[0, :4] == 0).all() and (got[0, 4:].abs() > 0).all()
    assert abs(aux.item() - 2.0) <= 2e-3


@pytest.fixture(scope="module")
def lm_pair():
    lm, params = seeded(build_model(LM, device="cpu"), 6)
    return jax_build_model(LM), params, lm


def test_moe_transformer_lm_loss_and_aux(lm_pair):
    """PAD tokens gated out of dispatch: loss, ``moe_aux`` and every
    gradient equal JAX's."""
    jm, params, lm = lm_pair
    rng = np.random.default_rng(0)
    src = rng.integers(3, 20, (3, 7)).astype(np.int32)
    src[1, 5:] = 0
    tgt = rng.integers(3, 20, (3, 7)).astype(np.int32)
    lens = np.array([7, 5, 7], np.int32)
    args = list(map(jnp.asarray, (src, tgt, lens)))
    (want, jaux), g = jax.jit(jax.value_and_grad(lambda p: jm.apply(p, *args), has_aux=True))(
        params)
    lm.zero_grad()
    got, aux = lm(*(torch.from_numpy(a).long() for a in (src, tgt, lens)))
    got.backward()
    close_rel(got, float(want))
    close_rel(aux["moe_aux"], float(jaux["moe_aux"]))
    assert np.abs(np.asarray(g["params"]["block_0"]["moe"]["router"]["dense"]["kernel"])).max() > 0
    mine = flat(grad_tree(lm))
    for key, w in flat(np_tree(g)["params"]).items():
        close_rel(mine[key], w, key=key)


def test_moe_transformer_lm_cached_decode_parity(lm_pair):
    """Length-1 steps route each row's token alone: at capacity factor 1.0
    (E/k = 1, drop-free) the cached steps equal JAX's steps and the
    full-prefix log-probs."""
    _, params, _ = lm_pair
    cfg = dict(LM, moe_capacity_factor=1.0)
    jm = jax_build_model(cfg)
    lm = compat.load_into(build_model(cfg, device="cpu"), params)
    tokens = np.random.default_rng(2).integers(1, 20, (3, 6)).astype(np.int32)
    full = jax.nn.log_softmax(jax.jit(lambda t: jm.apply(params, t, method="logits"))(
        jnp.asarray(tokens)))
    step = jax.jit(lambda tok, cache, i: jm.apply(params, tok, cache, i, method="decode_step"))
    cache_j, cache_t = jm.init_cache(3, 6), lm.init_cache(3, 6)
    for i in range(6):
        want, cache_j = step(jnp.asarray(tokens[:, i]), cache_j, jnp.asarray(i))
        with torch.no_grad():
            got, cache_t = lm.decode_step(torch.from_numpy(tokens[:, i]).long(), cache_t, i)
        close_rel(got, np.asarray(want))
        close_rel(got, np.asarray(full[:, i]), rel=2e-5)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 0.6)])
def test_routing_and_counts_equal_jax(top_k, cf):
    """Every choice's expert, kept or dropped, and each expert's count a
    row equal JAX's (read from JAX's own router logits and combine
    weights), ragged pads included; capacity binds here."""
    rng = np.random.default_rng(10 + top_k)
    x = rng.normal(size=(3, 17, 16)).astype(np.float32)
    mask = np.arange(17)[None] < np.array([17, 11, 4])[:, None]
    jm, params, tm = moe_pair(16, 24, seed=top_k, n_experts=4, top_k=top_k, capacity_factor=cf)
    experts, kept = parity.jax_routing(jm, params["params"], x, mask)
    with torch.no_grad():
        r = tm.route(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_array_equal(r.experts.numpy()[:, mask], experts[:, mask])
    onehot = np.eye(4, dtype=int)
    counts_t = (onehot[r.experts.numpy()] * r.kept.numpy()[..., None]).sum(axis=(0, 2))
    counts_j = (onehot[experts] * kept[..., None]).sum(axis=(0, 2))
    np.testing.assert_array_equal(counts_t, counts_j)
    assert r.cap == tm.capacity(17) and counts_t.max() == r.cap  # capacity binds
    assert (~kept[:, mask]).any()  # so valid tokens are dropped
    code = chip_smoke.routing_code(r.experts.numpy(), r.kept.numpy(), mask)
    assert code == chip_smoke.routing_code(experts, kept, mask)
    assert chip_smoke.routing_differ(code, code, top_k) == 0.0


# -------------------------------------------------------------- streaming
@pytest.mark.parametrize("name", ["speech2text", "conformer"])
def test_streaming_moe_encoder_matches_batch(pairs, name):
    """``test_online.py::test_streaming_moe_encoder_matches_batch`` in the
    port: at drop-free capacity (the transformer's weights at capacity
    2.0 = E / k) the stream, its chunk mask gating the dispatch, equals the
    offline encode, which equals JAX's (``check_pair``, at the configs'
    capacity)."""
    pair = pairs(name)
    cfg = dict(pair.cfg, encoder=dict(pair.cfg["encoder"], moe_capacity_factor=2.0))
    model = compat.load_into(build_model(cfg, device="cpu"), pair.params)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 64 + 9, F_IN)).astype(np.float32)
    with torch.no_grad():
        memory, memory_mask = model.encode(torch.from_numpy(x), torch.ones(2, 73, dtype=bool))
    if name == "conformer":  # drop-free as it is: the fixture's JAX memory is this input's
        close_rel(model.encode(*pair.torch_args()[:2])[0].detach(), pair.memory)
    sess = StreamingEncoderSession(model, batch=2)
    rc = sess.raw_chunk
    for s in range(64 // rc):
        sess.feed(x[:, s * rc:(s + 1) * rc])
    streamed, t_valid = sess.finish(x[:, 64:])
    assert t_valid == int(memory_mask[0].sum())
    close_rel(streamed[:, :t_valid], memory[:, :t_valid].numpy(), rel=2e-5)


def test_streamed_moe_routes_each_stream_on_its_own_frames():
    """A chunk step's MoE sees only its row's valid frames: a row whose
    chunk is all pad (a slot that does not advance) and the rows of other
    streams leave a row's output as it is, at binding capacity too."""
    enc = encoder.TransformerEncoder(d_model=16, n_heads=2, d_ff=24, n_blocks=1, chunk_size=4,
                                     left_chunks=1, moe_experts=2, moe_top_k=1,
                                     moe_capacity_factor=0.5).eval()
    x = torch.randn(3, 4, 16, generator=torch.Generator().manual_seed(0))
    chunk_mask = torch.tensor([[True, True, True, False], [False] * 4, [True] * 4])
    noisy = x.clone()
    noisy[1:] = torch.randn(2, 4, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, _ = enc.encode_step(x, enc.init_stream_cache(3), 0, 0, chunk_mask)
        alone, _ = enc.encode_step(x[:1], enc.init_stream_cache(1), 0, 0, chunk_mask[:1])
        y2, _ = enc.encode_step(noisy, enc.init_stream_cache(3), 0, 0, chunk_mask)
        kept = enc.block_0.moe.route(x, chunk_mask).kept
    assert kept[:, 1].sum() == 0 and kept[:, 0].sum() < 3  # capacity 1 binds on row 0
    torch.testing.assert_close(y[0, :3], alone[0, :3], rtol=0, atol=1e-6)
    torch.testing.assert_close(y[0, :3], y2[0, :3], rtol=0, atol=1e-6)


# ------------------------------------------------------------- transducer
def test_transducer_loss_with_an_moe_encoder(pairs):
    """The RNN-T loss plus ``moe_aux_weight``·``moe_aux``, the aux, the
    memory and every gradient equal JAX's."""
    check_pair(pairs("transducer"))


# ----------------------------------------------------------------- training
def test_one_trainer_update_matches_jax_trainer(pairs):
    """One micro-batch, clipped, Adam with weight decay at the Noam rate of
    step 1, router jitter 0: the port's Trainer (the training CLI's update)
    against the JAX Trainer's update of JAX's gradients; elements whose
    Adam input is rounding noise are left out, as in
    ``test_torch_port_train_families``."""
    pair = pairs("speech2text")
    jt = JaxTrainer(TRAIN, pair.jm, batch_fn=default_speech_batch)
    params0 = jax.tree_util.tree_map(jnp.asarray, pair.params["params"])
    lr = jt.schedule(1, 0)
    new_vars, _, skips, _ = jt._build_update_fn()(
        {"params": params0}, np_tree(jt.tx.init(params0)),
        jax.tree_util.tree_map(jnp.asarray, pair.grads), jnp.zeros((), jnp.int32), lr,
        jax.random.PRNGKey(9))
    assert int(skips) == 0
    model = compat.load_into(build_model(pair.cfg, device="cpu"), pair.params)
    trainer = Trainer(TRAIN, model, None, torch.Generator().manual_seed(0))
    model.train()
    trainer.micro_step(pair.batch)
    rec = trainer.update()
    assert rec["applied"] and rec["lr"] == lr
    np.testing.assert_allclose(rec["losses"], [pair.loss], rtol=RTOL)
    np.testing.assert_allclose(rec["aux"]["moe_aux"], [pair.aux["moe_aux"]], rtol=RTOL)
    grads, p0 = flat(pair.grads), flat(pair.params["params"])
    gnorm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    clip = min(1.0, TRAIN["clip_grad"] / (gnorm + 1e-6))
    wd = TRAIN["optimizer"]["weight_decay"]
    got = flat(compat.params_to_jax(model)["params"])
    left_out, total = 0, 0
    for key, w in flat(np_tree(new_vars)["params"]).items():
        u = np.abs(clip * grads[key] + wd * p0[key])
        keep = u >= 1e-3 * np.median(u)
        left_out, total = left_out + int((~keep).sum()), total + u.size
        np.testing.assert_allclose(got[key][keep], w[keep], rtol=0, atol=1e-5, err_msg=key)
    assert left_out <= 1e-3 * total and any("/moe/" in k for k in got)


def test_router_jitter_in_training_only_from_the_generator():
    """The jitter scales the router's input by U(1 − j, 1 + j) in training
    only, drawn from the generator ``set_dropout_generator`` hands out
    (reseeding replays it); training without one raises."""
    j = 0.3
    moe = MoEFeedForward(2, 4, n_experts=2, top_k=1, router_jitter=j)
    with torch.no_grad():
        moe.router.weight.copy_(torch.tensor([[1.0, 0.0], [0.0, 0.0]]))
        moe.router.bias.zero_()
    x = torch.rand(4, 50, 2) + 0.5

    def scale(r):  # logit_0 − logit_1 = the jittered x[..., 0]
        p = r.probs[..., 0].double()
        return (torch.log(p) - torch.log1p(-p)) / x[..., 0].double()

    with torch.no_grad():
        torch.testing.assert_close(scale(moe.eval().route(x)),
                                   torch.ones(4, 50, dtype=torch.float64), rtol=0, atol=1e-5)
        moe.train()
        with pytest.raises(RuntimeError, match="generator"):
            moe.route(x)
        set_dropout_generator(moe, torch.Generator().manual_seed(5))
        s = scale(moe.route(x))
        set_dropout_generator(moe, torch.Generator().manual_seed(5))
        again = scale(moe.route(x))
    assert torch.equal(s, again)
    assert float(s.min()) >= 1 - j - 1e-4 and float(s.max()) <= 1 + j + 1e-4
    assert float(s.max() - s.min()) > j  # spread over the support


def test_router_stays_float32_when_the_model_is_cast():
    """The router's parameters stay float32 in a bfloat16 model, as JAX's
    float32 router, and the bfloat16 encode runs."""
    model = build_model(CFGS["speech2text"], dtype=torch.bfloat16, device="cpu")
    moe = model.encoder.block_1.moe
    assert moe.router.weight.dtype == torch.float32 and moe.w1.dtype == torch.bfloat16
    args = feature_like(speech_batch(LENS["speech2text"]))
    with torch.no_grad():
        mem, _ = model.encode(*args)
    assert mem.dtype == torch.bfloat16 and torch.isfinite(mem.float()).all()


def feature_like(batch):
    _, inputs, _ = batch
    return torch.from_numpy(inputs["inputs"]), torch.from_numpy(inputs["mask"])


# ------------------------------------------------------- layouts, .pt, warnings
@pytest.mark.parametrize("layout", ["speech2text", "scan_layers"])
def test_params_round_trip_in_both_layouts(pairs, layout):
    """``params_to_jax`` gives the JAX tree (per block, or ``scan_layers``
    stacked [L, E, ...]) and ``params_from_jax`` maps it back exactly."""
    pair = pairs(layout)
    got = compat.params_to_jax(pair.model)
    for k, v in flat(pair.params).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    assert flat(got).keys() == flat(pair.params).keys()
    back = compat.params_from_jax(got)
    assert back.keys() == pair.model.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in pair.model.state_dict().items())
    if layout == "scan_layers":
        assert got["params"]["encoder"]["blocks"]["moe"]["w2"].shape == (2, 2, 48, D)
        unstacked = compat.params_from_jax(compat.from_scan_layout(got))
        assert all(torch.equal(unstacked[k], v) for k, v in back.items())


def test_reference_pt_has_no_moe(pairs):
    """The reference has no MoE: the JAX package's export raises (a
    KeyError on the MoE block) and its import gives a tree without the
    ``moe`` parameters; the port refuses both by name."""
    pair = pairs("speech2text")
    with pytest.raises(KeyError):
        jax_compat.export_reference_checkpoint(pair.params, {"model": pair.cfg})
    with pytest.raises(NotImplementedError, match="mixture of experts"):
        compat.export_reference_checkpoint(pair.model, {"model": pair.cfg})
    enc = {k: v for k, v in TRANSFORMER.items() if not k.startswith("moe")}
    dense_cfg = dict(pair.cfg, encoder=enc)
    chkpt = compat.export_reference_checkpoint(build_model(dense_cfg, device="cpu"),
                                               {"model": dense_cfg})
    tree = jax_compat.convert_reference_checkpoint(
        {k: v if k == "params" else {n: t.numpy() for n, t in v.items()}
         for k, v in chkpt.items()}, pair.cfg)
    assert "moe" not in tree["params"]["encoder"]["block_1"]
    with pytest.raises(NotImplementedError, match="mixture of experts"):
        compat.convert_reference_checkpoint(chkpt, pair.cfg)


def test_the_two_warnings(caplog):
    """Streaming an MoE encoder whose capacity can bind, and building an
    MoE LM for recognition whose capacity can bind, each warn once, as in
    JAX; the drop-free configs do not."""
    s2t = build_model(CFGS["speech2text"], device="cpu")
    with caplog.at_level(logging.WARNING):
        for cf, warns in ((1.25, 1), (2.0, 0)):
            caplog.clear()
            encoder.ConformerEncoder(**dict(CONFORMER, moe_capacity_factor=cf)).init_stream_cache(1)
            assert caplog.text.count("streaming an MoE encoder") == warns
            caplog.clear()
            jax_encoder.ConformerEncoder(**dict(CONFORMER, moe_capacity_factor=cf)
                                         ).init_stream_cache(1)
            assert caplog.text.count("streaming an MoE encoder") == warns
        for cf, warns in ((0.5, 1), (1.0, 0)):  # E / k = 1
            caplog.clear()
            make_memory_search(s2t, 3, 4, lm=build_model(dict(LM, moe_capacity_factor=cf),
                                                         device="cpu"))
            assert caplog.text.count("MoE LM built for recognition") == warns


# ---------------------------------------------------------------------- CLI
def test_cli_trains_averages_and_reloads_an_moe_model(tmp_path):
    """The training CLI on a tiny MoE model with router jitter and dropout
    on: ``moe_aux`` of every micro-batch in the history, finite; the two
    epochs' checkpoints average (``cli/average.py``) and reload; ``--ep 1``
    is accepted, and ``--ep 2`` (which raised until parallelism was ported)
    trains on two ranks that split the experts, with the single run's losses
    (the two ranks draw the single run's dropout and jitter)."""
    root = str(tmp_path)
    chip_smoke.make_ctc_corpus(root)
    cfg = chip_smoke.ctc_corpus_config(root, epochs=2)
    cfg["model"] = {"type": "speech2text", "frontend_type": "conv",
                    "frontend": dict(FRONT, input_size=chip_smoke.CTC_CORPUS["feat_dim"]),
                    "encoder_type": "transformer",
                    "encoder": dict(TRANSFORMER, residual_dropout=0.1, moe_router_jitter=0.01),
                    "decoder": dict(DECODER, vocab_size=chip_smoke.CTC_CORPUS["vocab"])}
    conf = os.path.join(root, "conf.json")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    expdir = os.path.join(root, "exp")
    trainer = run_cli.run(["-c", conf, "--expdir", expdir, "--ep", "1", "--device", "cpu",
                           "--log_interval", "1"])
    record = os.path.join(root, "ep2.jsonl")
    assert run_cli.run(["-c", conf, "--expdir", os.path.join(root, "ep2"), "--ep", "2",
                        "--device", "cpu", "--record", record]) is None
    with open(record) as f:
        ep2 = json.loads(f.readline())
    np.testing.assert_allclose(ep2["losses"], [x for r in trainer.history for x in r["losses"]],
                               rtol=1e-5)
    aux = [x for r in trainer.history for x in r["aux"]["moe_aux"]]
    assert len(aux) == sum(len(r["losses"]) for r in trainer.history) > 0
    assert np.isfinite(aux).all() and trainer.nan_skips == 0
    assert average_cli.main([expdir, "0", "1"]) == 0
    ck = Checkpointer(expdir)
    tree = ck.load_params(os.path.join(expdir, "model.average.from0to1"))
    model = compat.load_into(build_model(cfg["model"], device="cpu"), tree)
    e0, e1 = (flat(ck.load_params(ck.epoch_path(e))) for e in (0, 1))
    key = "params/encoder/block_1/moe/w1"
    np.testing.assert_allclose(flat(tree)[key], (e0[key] + e1[key]) / 2, rtol=0, atol=1e-6)
    assert not torch.equal(model.encoder.block_1.moe.w1, torch.from_numpy(e0[key]))
