"""The port's streamed encode and streaming recognizers against the JAX
package, on the CPU.

``stream_kv_mask``, ``PositionalEncoding`` with a start, both attention
``chunk_step``s, the conv module's ``conv_step``, both encoders'
``encode_step`` (through ``StreamingEncoderSession``, while the caches are
still filling, with and without a partial tail chunk, and directly with
ragged per-row positions), the CTC and attention online recognizers, the
windowed long-form encode, and the multi-stream servers (ragged rows, slot
reuse, concurrent ``run_stream`` threads, an empty stream) are held to
their JAX counterparts and to the port's own offline chunk-masked encode;
the committed full-width stream fixture's first 2 utterances are held
without JAX.

Small models (d 24-32, 2 blocks, V = 20-50, chunk 4, left 2), inputs from
numpy seeds, the JAX weights carried over by ``compat``. Tolerance 1e-5
absolute for float32 module outputs, caches and memories (XLA and PyTorch
sum in other orders); token ids equal; the fixture at ``chip_smoke``'s
limits.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentransformer_tpu.models import encoder as jax_encoder
from opentransformer_tpu.models import modules as jax_modules
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize import multistream as jax_ms
from opentransformer_tpu.recognize import online as jax_online
from opentransformer_tpu.recognize import streaming as jax_streaming
from opentransformer_tpu.recognize.base import make_memory_search as jax_memory_search
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.models import encoder, modules
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize import multistream, online, streaming
from opentransformer_tpu_torch.recognize.base import make_memory_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ATOL = 1e-5
F_IN, D, H, V = 12, 24, 2, 20
FRONTEND = {"input_size": F_IN, "output_size": D, "mid_channel": 4, "out_channel": 8}
TRANSFORMER = {"d_model": D, "n_heads": H, "d_ff": 32, "n_blocks": 2, "residual_dropout": 0.0,
               "activation": "glu", "chunk_size": 4, "left_chunks": 2}
CONFORMER = {"d_model": D, "n_heads": H, "d_ff": 32, "nblocks": 2, "cov_kernel_size": 5,
             "residual_dropout": 0.0, "conv_causal": True, "chunk_size": 4, "left_chunks": 2}
ENCODERS = {
    "transformer": ("transformer", TRANSFORMER),
    "transformer-relpos-prenorm": ("transformer", dict(TRANSFORMER, relative_positional=True,
                                                       normalize_before=True)),
    "conformer": ("conformer", CONFORMER),
    "conformer-abspos-convfirst": ("conformer", dict(CONFORMER, relative_positional=False,
                                                     conv_first=True)),
}


def model_cfg(variant="conformer", mtype="ctc"):
    etype, enc = ENCODERS[variant]
    cfg = {"type": mtype, "frontend_type": "conv", "frontend": FRONTEND, "encoder_type": etype,
           "encoder": enc}
    if mtype == "ctc":
        return dict(cfg, vocab_size=V, lookahead_steps=0)
    return dict(cfg, decoder={"vocab_size": V, "d_model": D, "n_heads": H, "d_ff": 32,
                              "memory_dim": D, "n_blocks": 1, "residual_dropout": 0.0,
                              "activation": "glu", "share_embedding": False})


def pair(cfg, seed=0):
    """(port model on the CPU, JAX model, JAX variables) with the same
    seeded weights."""
    model = build_model(cfg, device="cpu")
    params = chip_smoke.seeded_params(model, seed)
    compat.load_into(model, params)
    return model, jax_build_model(cfg), jax.tree_util.tree_map(jnp.asarray, params)


def feats_of(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(t, F_IN)).astype(np.float32) for t in lens]


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()), np.asarray(want),
                               rtol=0, atol=atol)


def init(module, *args, seed=0, **kw):
    return module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args), **kw)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("cache_len", [3, [0, 5, 8]], ids=["scalar", "per-row"])
def test_stream_kv_mask_matches_jax(cache_len):
    chunk_mask = np.array([[True] * 4, [True] * 4, [True, True, False, False]])
    for cm in (None, chunk_mask):
        want = jax_encoder.stream_kv_mask(3, 8, 4, jnp.asarray(cache_len),
                                          None if cm is None else jnp.asarray(cm))
        got = encoder.stream_kv_mask(3, 8, 4, torch.tensor(cache_len),
                                     None if cm is None else torch.from_numpy(cm))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start", [7, [0, 13, 40]], ids=["scalar", "per-row"])
def test_positional_encoding_with_start_matches_jax(start):
    x = np.random.default_rng(1).normal(size=(3, 5, D)).astype(np.float32)
    jpe = jax_modules.PositionalEncoding(D)
    want = jpe.apply({}, jnp.asarray(x), start=jnp.asarray(start))
    got = modules.PositionalEncoding(D)(torch.from_numpy(x), start=torch.tensor(start))
    close(got, want)
    assert modules.PositionalEncoding(D)(torch.from_numpy(x)).shape == (3, 5, D)


def _chunk_step_inputs(seed, b=3, c=4, left=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, D)).astype(np.float32)
    ck = rng.normal(size=(b, H, left, D // H)).astype(np.float32)
    cv = rng.normal(size=(b, H, left, D // H)).astype(np.float32)
    chunk_mask = np.ones((b, c), bool)
    chunk_mask[2, 3:] = False  # a partial final chunk
    kv_mask = np.asarray(jax_encoder.stream_kv_mask(b, left, c, jnp.asarray([0, 4, 8]),
                                                    jnp.asarray(chunk_mask)))
    return x, ck, cv, kv_mask


def _held(jmod, variables, tmod, x, ck, cv, kv_mask):
    want = jmod.apply(variables, *map(jnp.asarray, (x, ck, cv, kv_mask)), method="chunk_step")
    got = tmod.chunk_step(*(torch.from_numpy(a) for a in (x, ck, cv, kv_mask)))
    for g, w in zip(got, want):
        close(g.detach(), w)


def test_mhsa_chunk_step_matches_jax():
    x, ck, cv, kv_mask = _chunk_step_inputs(2)
    jmod = jax_modules.MultiHeadSelfAttention(H, D)
    variables = init(jmod, x)
    tmod = compat.load_into(modules.MultiHeadSelfAttention(H, D), variables).eval()
    _held(jmod, variables, tmod, x, ck, cv, kv_mask)


@pytest.mark.parametrize("kw", [{}, {"use_out_proj": False}, {"share_qvk_proj": True},
                                {"skip_term_b": True}],
                         ids=["default", "no-out-proj", "shared-qvk", "skip-term-b"])
def test_rel_pos_chunk_step_matches_jax(kw):
    """Every cache depth at once (rows at 0, 4 and 8 of 8 valid frames): the
    position-term gather ``k − q + C − 1`` is held while the cache fills."""
    x, ck, cv, kv_mask = _chunk_step_inputs(3)
    jmod = jax_modules.RelPosSelfAttention(H, D, **kw)
    # initialized through a one-frame call: the JAX package's batch path
    # with skip_term_b works only at T = 1 (its chunk step at any C)
    variables = init(jmod, x[:, :1])
    tmod = compat.load_into(modules.RelPosSelfAttention(H, D, **kw), variables).eval()
    _held(jmod, variables, tmod, x, ck, cv, kv_mask)


@pytest.mark.parametrize("norm_type", ["layer", "batch"])
def test_conv_step_matches_jax_and_the_causal_batch_conv(norm_type):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    jmod = jax_modules.ConformerConvModule(D, kernel_size=5, norm_type=norm_type, causal=True)
    variables = init(jmod, x)
    tmod = compat.load_into(modules.ConformerConvModule(D, 5, norm_type, causal=True),
                            variables).eval()
    jstate = jnp.zeros((2, 4, D))
    tstate = torch.zeros((2, 4, D))
    outs = []
    with torch.no_grad():
        for s in range(0, 16, 4):
            jy, jstate = jmod.apply(variables, jnp.asarray(x[:, s:s + 4]), jstate,
                                    method="conv_step")
            ty, tstate = tmod.conv_step(torch.from_numpy(x[:, s:s + 4]), tstate)
            close(ty, jy)
            close(tstate, jstate)
            outs.append(ty)
        close(torch.cat(outs, dim=1), tmod(torch.from_numpy(x)))


# ----------------------------------------------------------------- encoders
def _session_chunks(session, x, tail):
    out = []
    rc = session.raw_chunk
    full = x.shape[1] // rc
    for s in range(full):
        out += session.feed(x[:, s * rc:(s + 1) * rc])
    out += session.flush(x[:, full * rc:] if tail else None)
    return out


@pytest.mark.parametrize("tail_frames", [0, 9])
@pytest.mark.parametrize("variant", list(ENCODERS))
def test_streamed_encode_matches_jax_and_the_offline_chunked_encode(variant, tail_frames):
    """Chunk by chunk from the first (caches still filling) against JAX's
    session, and the stitched memory against the port's offline encode
    under the chunk mask."""
    cfg = model_cfg(variant)
    model, jm, variables = pair(cfg, seed=1)
    x = np.stack(feats_of(5, [80 + tail_frames] * 2))
    got = _session_chunks(online.StreamingEncoderSession(model, batch=2), x, tail_frames)
    want = _session_chunks(jax_online.StreamingEncoderSession(jm, variables, batch=2), x,
                           tail_frames)
    assert [g.shape[1] for g in got] == [w.shape[1] for w in want]
    for g, w in zip(got, want):
        close(g, w)
    with torch.no_grad():
        mem, mask = model.encode(torch.from_numpy(x), torch.ones(x.shape[:2], dtype=torch.bool))
    stitched = torch.cat(got, dim=1)
    assert stitched.shape[1] == int(mask[0].sum()) == model.frontend.output_length(x.shape[1])
    close(stitched, mem)


@pytest.mark.parametrize("variant", ["transformer", "conformer"])
def test_encode_step_with_ragged_rows_matches_jax(variant):
    """Per-row ``start`` and ``cache_len`` (rows at three stream depths, one
    chunk partial) over random cache contents."""
    cfg = model_cfg(variant)
    model, jm, variables = pair(cfg, seed=2)
    rng = np.random.default_rng(6)
    cache = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in lc.items()}
             for lc in model.encoder.init_stream_cache(3)]
    x = rng.normal(size=(3, 4, D)).astype(np.float32)
    start, cache_len = np.array([0, 4, 36]), np.array([0, 4, 8])
    chunk_mask = np.array([[True] * 4, [True] * 4, [True, False, False, False]])

    def jstep(m, x, cache, start, cache_len, chunk_mask):
        return m.encoder.encode_step(x, cache, start, cache_len, chunk_mask)

    want, want_cache = jm.apply(variables, jnp.asarray(x),
                                jax.tree_util.tree_map(jnp.asarray, cache), jnp.asarray(start),
                                jnp.asarray(cache_len), jnp.asarray(chunk_mask), method=jstep)
    with torch.no_grad():
        got, got_cache = model.encoder.encode_step(
            torch.from_numpy(x), [{k: torch.from_numpy(v) for k, v in lc.items()}
                                  for lc in cache],
            torch.from_numpy(start), torch.from_numpy(cache_len), torch.from_numpy(chunk_mask))
    close(got, want)
    for g, w in zip(got_cache, want_cache):
        assert g.keys() == w.keys()
        for key in g:
            close(g[key], w[key])


def test_streaming_needs_a_chunked_causal_encoder():
    with pytest.raises(ValueError, match="chunk_size > 0"):
        build_model(dict(model_cfg("transformer"), encoder=dict(TRANSFORMER, chunk_size=0)),
                    device="cpu").encoder.init_stream_cache(1)
    with pytest.raises(ValueError, match="left_chunks >= 0"):
        online.StreamingEncoderSession(build_model(
            dict(model_cfg("conformer"), encoder=dict(CONFORMER, left_chunks=-1)), device="cpu"))
    with pytest.raises(ValueError, match="conv_causal"):
        build_model(dict(model_cfg("conformer"), encoder=dict(CONFORMER, conv_causal=False)),
                    device="cpu").encoder.init_stream_cache(1)


def test_transducer_streaming_raises():
    """The transducer's streaming recognizers are ported: the calls that
    raised build now, and each decodes a stream (the same ids)."""
    cfg = {"type": "transducer", "frontend_type": "conv", "frontend": FRONTEND,
           "encoder_type": "transformer", "encoder": TRANSFORMER, "vocab_size": V}
    model = build_model(cfg, device="cpu")
    x = feats_of(8, [45])[0]
    texts = []
    for rec in (online.StreamingTransducerRecognizer(model),
                online.OnlineRecognizerAdapter("transducer", model)._rec):
        texts.append(_feed_all(rec, x[None])[0])
    texts.append(multistream.MultiStreamTransducer(model).run_stream(x, lambda _t: None))
    assert texts[0] == texts[1] == texts[2]


# -------------------------------------------------------------- recognizers
def _feed_all(rec, x):
    rc = rec.session.raw_chunk
    full = x.shape[1] // rc
    for s in range(full):
        rec.feed(x[:, s * rc:(s + 1) * rc])
    return rec.finish(x[:, full * rc:])


def test_streaming_ctc_recognizer_matches_jax_and_the_offline_greedy():
    model, jm, variables = pair(model_cfg("conformer"), seed=3)
    x = np.stack(feats_of(7, [93, 93]))
    rec = online.StreamingCTCRecognizer(model, batch=2)
    texts = _feed_all(rec, x)
    jrec = jax_online.StreamingCTCRecognizer(jm, variables, batch=2)
    assert texts == _feed_all(jrec, x)
    assert rec.tokens == jrec.tokens
    with torch.no_grad():
        ids, mask = model.recognize_argmax(torch.from_numpy(x), torch.ones(2, 93, dtype=torch.bool))
    for b in range(2):
        want, last = [], 0
        for i in ids[b, : int(mask[b].sum())].tolist():
            if i not in (0, last):
                want.append(i)
            last = i
        assert rec.tokens[b] == want
    assert any(rec.tokens)
    with pytest.raises(NotImplementedError, match="lookahead_steps=0"):
        online.StreamingCTCRecognizer(build_model(dict(model_cfg("conformer"), lookahead_steps=2),
                                                  device="cpu"))


def test_streaming_attention_final_equals_the_offline_beam_and_jax():
    """Partials re-decode the memory so far; the FINAL equals the offline
    beam over the chunked memory, and JAX's FINAL."""
    model, jm, variables = pair(model_cfg("conformer", "speech2text"), seed=4)
    x = np.stack(feats_of(8, [101]))
    kw = dict(beam_width=3, max_len=6, eos_id=-1, mem_bucket=8)
    rec = online.StreamingAttentionRecognizer(model, **kw)
    partials = []
    rc = rec.session.raw_chunk
    for s in range(x.shape[1] // rc):
        partials.append(rec.feed(x[:, s * rc:(s + 1) * rc]))
    final = rec.finish(x[:, x.shape[1] // rc * rc:])
    jrec = jax_online.StreamingAttentionRecognizer(jm, variables, **kw)
    assert final == _feed_all(jrec, x)
    assert any(p[0] for p in partials)
    with torch.no_grad():
        mem, mask = model.encode(torch.from_numpy(x), torch.ones(1, 101, dtype=torch.bool))
    hyp = make_memory_search(model, 3, 6, eos_id=-1)(mem, mask)
    assert rec.tokens[0] == hyp.tokens[0, 0, 1: int(hyp.lengths[0, 0])].tolist()
    assert len(rec.tokens[0]) == 6


def test_online_adapter_decodes_each_utterance_alone():
    model = pair(model_cfg("conformer"), seed=3)[0]
    x = np.stack(feats_of(9, [90, 90]))
    mask = np.arange(90)[None] < np.array([[90], [61]])
    texts, scores = online.OnlineRecognizerAdapter("ctc", model).recognize(
        torch.from_numpy(x), torch.from_numpy(mask))
    for i, n in enumerate((90, 61)):
        rec = online.StreamingCTCRecognizer(model)
        assert texts[i] == [_feed_all(rec, x[i: i + 1, :n])[0]]
    assert scores.shape == (2, 1)


def test_encode_windowed_and_long_form_match_jax():
    """Window 48, context 8 (centre 32) over ragged inputs of 140 and 117
    frames: the stitched memory and its mask, and the beam over it."""
    cfg = model_cfg("conformer", "speech2text")
    model, jm, variables = pair(cfg, seed=5)
    x = np.zeros((2, 140, F_IN), np.float32)
    lens = np.array([140, 117])
    for i, f in enumerate(feats_of(10, lens)):
        x[i, : len(f)] = f
    mem, mask = streaming.encode_windowed(model, torch.from_numpy(x), torch.from_numpy(lens),
                                          window=48, context=8)
    jmem, jmask = jax_streaming.encode_windowed(jm, variables, jnp.asarray(x), lens, window=48,
                                                context=8)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    close(mem, jmem)
    feat_mask = torch.from_numpy(np.arange(140)[None] < lens[:, None])
    rec = streaming.LongFormRecognizer(model, beam_width=3, max_len=6, eos_id=-1, window=48,
                                       context=8)
    hyp = rec.recognize_arrays(torch.from_numpy(x), feat_mask)
    jhyp = jax_memory_search(jm, 3, 6, eos_id=-1)(variables, jmem, jmask)
    assert np.array_equal(hyp.tokens.numpy(), np.asarray(jhyp.tokens))
    with pytest.raises(ValueError, match="multiples"):
        streaming.encode_windowed(model, torch.from_numpy(x), torch.from_numpy(lens), 50, 9)


# ------------------------------------------------------------- multi-stream
def _single_stream(model, utts):
    rec = online.StreamingCTCRecognizer(model)
    out = []
    for u in utts:
        rec.reset()
        out.append(_feed_all(rec, u[None])[0])
    return out


@pytest.mark.parametrize("variant", ["transformer", "conformer"])
def test_multistream_ctc_with_ragged_rows_matches_jax(variant):
    """Four streams opened on four ticks (rows at four depths), each pushed
    whole: the port's transcripts equal JAX's and the single-stream
    recognizer's, one fused step a tick."""
    model, jm, variables = pair(model_cfg(variant), seed=6)
    utts = feats_of(11, [64, 73, 41, 96])
    x = np.zeros((4, 96, F_IN), np.float32)
    for i, u in enumerate(utts):
        x[i, : len(u)] = u
    mask = np.arange(96)[None] < np.array([len(u) for u in utts])[:, None]
    ms = multistream.MultiStreamCTC(model, n_streams=4)
    _, finals = chip_smoke.staggered(ms, x, mask)
    jms_ = jax_ms.MultiStreamCTC(jm, variables, n_streams=4)
    _, jfinals = chip_smoke.staggered(jms_, x, mask)
    assert finals == jfinals
    assert [finals[i] for i in range(4)] == _single_stream(model, utts)
    assert ms.ticks == jms_.ticks and ms.chunks_advanced == jms_.chunks_advanced
    assert ms.ticks < ms.chunks_advanced


def test_multistream_slot_reuse_does_not_leak():
    """Three streams through two slots, one after another: the reused slot's
    KV caches are masked by cache_len = 0 and a conformer's conv state is
    zeroed, so each transcript equals the single-stream one."""
    model = pair(model_cfg("conformer"), seed=7)[0]
    utts = feats_of(12, [64, 48, 72])
    ms = multistream.MultiStreamCTC(model, n_streams=2)
    assert [ms.run_stream(u, lambda _t: None) for u in utts] == _single_stream(model, utts)
    assert ms.free_slots() == 2


def test_multistream_concurrent_run_stream_threads():
    model = pair(model_cfg("conformer"), seed=8)[0]
    utts = feats_of(13, [64, 56, 88, 48])
    ms = multistream.MultiStreamCTC(model, n_streams=2)
    got, partials = [None] * 4, [0] * 4

    def worker(i):
        def on_partial(_t):
            partials[i] += 1
        got[i] = ms.run_stream(utts[i], on_partial)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == _single_stream(model, utts)
    assert any(partials) and ms.free_slots() == 2


def test_multistream_empty_stream_finalizes():
    model = pair(model_cfg("conformer"), seed=8)[0]
    ms = multistream.MultiStreamCTC(model, n_streams=2)
    assert ms.run_stream(np.zeros((0, F_IN), np.float32), lambda _t: None) == ""
    assert ms.run_stream(np.zeros((3, F_IN), np.float32), lambda _t: None) == ""
    assert ms.ticks == 0 and ms.free_slots() == 2
    with pytest.raises(ValueError, match="frames"):
        ms.push(0, np.zeros((4, F_IN + 1), np.float32))


def test_multistream_attention_matches_jax_and_the_offline_beam():
    """Ragged staggered rows through one batched beam re-decode a tick (a
    partial for every row each tick): FINALs equal JAX's and each
    utterance's offline beam over its chunked memory."""
    model, jm, variables = pair(model_cfg("conformer", "speech2text"), seed=9)
    utts = feats_of(14, [64, 85, 49])
    x = np.zeros((3, 85, F_IN), np.float32)
    for i, u in enumerate(utts):
        x[i, : len(u)] = u
    mask = np.arange(85)[None] < np.array([len(u) for u in utts])[:, None]
    kw = dict(beam_width=3, max_len=5, eos_id=-1, mem_bucket=8)
    ms = multistream.MultiStreamAttention(model, n_streams=3, **kw)
    _, finals = chip_smoke.staggered(ms, x, mask)
    jms_ = jax_ms.MultiStreamAttention(jm, variables, n_streams=3, **kw)
    _, jfinals = chip_smoke.staggered(jms_, x, mask)
    assert finals == jfinals
    assert ms.decode_dispatches == jms_.decode_dispatches > 0
    search = make_memory_search(model, 3, 5, eos_id=-1)
    for i, u in enumerate(utts):
        with torch.no_grad():
            mem, mm = model.encode(torch.from_numpy(u[None]),
                                   torch.ones(1, len(u), dtype=torch.bool))
        hyp = search(mem, mm)
        assert finals[i] == " ".join(map(str, hyp.tokens[0, 0, 1:6].tolist()))


# ---------------------------------------------------------------- full width
def test_full_width_stream_holds_to_the_jax_fixture():
    """``conformer_streaming`` at full width on the CPU, without JAX: the
    fixture's first 2 utterances through the session (memory projection)
    and through ``MultiStreamCTC`` (ids), at ``chip_smoke``'s limits."""
    offline = chip_smoke.load_conformer_fixture()
    fixture = chip_smoke.load_stream_fixture()
    feats, mask, _ = chip_smoke.fixture_inputs(offline)
    feats, mask = feats[:2], mask[:2]
    model = chip_smoke.seeded_conformer(chip_smoke.STREAM_NAME, offline, device="cpu")
    probe = torch.from_numpy(chip_smoke.memory_probe(384, offline["inputs"]["probe_seed"]))
    for i, mem in enumerate(chip_smoke.session_memory(model, feats, mask)):
        want = np.asarray(fixture["stream"]["memory"][i], np.float32)
        close(mem @ probe, want, atol=chip_smoke.STREAM_MEMORY_ATOL)
    ctc_model, params = chip_smoke.seeded_stream_ctc(device="cpu")
    assert chip_smoke.checksum(params) == pytest.approx(fixture["checksums"]["ctc_weights"],
                                                        rel=1e-9)
    _, finals = chip_smoke.staggered(multistream.MultiStreamCTC(ctc_model, n_streams=2), feats,
                                     mask)
    assert [[int(t) for t in finals[i].split()] for i in range(2)] == fixture["ctc"]["ids"][:2]
