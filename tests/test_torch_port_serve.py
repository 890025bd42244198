"""The port's serving CLI and the eval CLI's streaming modes, on the CPU.

``FeatureExtractor`` and ``StreamingFbank`` (causal running CMVN included)
on seeded wavs, and the ``DynamicBatcher``'s answers, are held to the JAX
package's ``cli/serve.py`` on the same inputs and weights. The serve CLI
runs end to end on the CPU from a checkpoint written to ``tmp_path`` (npz +
a training run's JSON config): file mode, TCP lines, streaming over wav
lines and concurrent PCM streams, each held to the port's own offline
decode of the same features. The eval CLI's ``--online`` and
``--long_form`` are held to the offline decode and to
``LongFormRecognizer``.

Tolerance: features 1e-5 absolute (float32 fbank on the host in both
packages); transcripts equal. Every socket has a timeout, so a hung server
fails its test.
"""

import json
import os
import socket
import struct
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile as siw
import torch

from opentransformer_tpu.cli import serve as jax_serve
from opentransformer_tpu.models.registry import build_model as jax_build_model
from opentransformer_tpu.recognize.base import build_recognizer as jax_build_recognizer
from opentransformer_tpu_torch import compat
from opentransformer_tpu_torch.cli import eval as eval_cli
from opentransformer_tpu_torch.cli import serve
from opentransformer_tpu_torch.data import write_vocab
from opentransformer_tpu_torch.data.kaldi_io import write_ark
from opentransformer_tpu_torch.models.registry import build_model
from opentransformer_tpu_torch.recognize.base import build_recognizer, make_memory_search
from opentransformer_tpu_torch.recognize.ctc_decode import ctc_collapse_ids
from opentransformer_tpu_torch.recognize.streaming import LongFormRecognizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ATOL = 1e-5
MEL, D, V = 20, 24, 30
TIMEOUT = 60.0
FRONTEND = {"input_size": MEL, "output_size": D, "mid_channel": 4, "out_channel": 8}
CONFORMER = {"d_model": D, "n_heads": 2, "d_ff": 32, "nblocks": 2, "cov_kernel_size": 5,
             "residual_dropout": 0.0, "conv_causal": True, "chunk_size": 4, "left_chunks": 2}
DECODER = {"vocab_size": V, "d_model": D, "n_heads": 2, "d_ff": 32, "memory_dim": D,
           "n_blocks": 1, "residual_dropout": 0.0, "activation": "glu", "share_embedding": False}
CTC_CFG = {"type": "ctc", "frontend": FRONTEND, "encoder_type": "conformer",
           "encoder": CONFORMER, "vocab_size": V}
S2T_CFG = {"type": "speech2text", "frontend": FRONTEND, "encoder_type": "conformer",
           "encoder": CONFORMER, "decoder": DECODER}


def waves(n, seed, min_s=0.6, max_s=1.6):
    """Seeded int16 wavs: noise plus two tones."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = np.arange(int(rng.uniform(min_s, max_s) * 16000)) / 16000.0
        w = 0.05 * rng.normal(size=t.size) + sum(
            a * np.sin(2 * np.pi * f * t)
            for a, f in zip(rng.uniform(0.05, 0.3, 2), rng.uniform(100, 4000, 2)))
        out.append((np.clip(w, -1, 1) * 32767).astype(np.int16))
    return out


def write_wavs(root, wavs):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, w in enumerate(wavs):
        paths.append(os.path.join(root, f"utt{i}.wav"))
        siw.write(paths[-1], 16000, w)
    with open(os.path.join(root, "wav.scp"), "w") as f:
        f.write("".join(f"utt{i} {p}\n" for i, p in enumerate(paths)))
    return paths


def seeded(cfg, seed):
    """The port model of ``cfg`` with seeded weights, and those weights (JAX
    layout). A speech2text decoder's EOS logit is pushed down, so that the
    random decoder does not end every hypothesis at its first step and the
    texts compared are not all empty."""
    model = build_model(cfg, device="cpu")
    params = chip_smoke.seeded_params(model, seed)
    if cfg["type"] == "speech2text":
        params["params"]["decoder"]["output_layer"]["dense"]["bias"][1] = -5.0
    compat.load_into(model, params)
    return model, params


def checkpoint(root, cfg, data_cfg, seed=0):
    """npz + a training run's config.json for ``cfg``, with a vocab; returns
    (npz, config path, the loaded port model, its JAX params)."""
    os.makedirs(root, exist_ok=True)
    vocab = os.path.join(root, "vocab")
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{f"u{i}": i for i in range(3, V)}}, vocab)
    model, params = seeded(cfg, seed)
    npz, conf = os.path.join(root, "w.npz"), os.path.join(root, "config.json")
    compat.save_npz(npz, params, dtype=np.float32)
    with open(conf, "w") as f:
        json.dump({"data": dict(data_cfg, vocab=vocab), "model": cfg}, f)
    return npz, conf, model, params


def idx2unit_of(conf):
    with open(conf) as f:
        vocab = json.load(f)["data"]["vocab"]
    from opentransformer_tpu_torch.data import load_idx2unit_map

    return load_idx2unit_map(vocab)


# ----------------------------------------------------------------- features
@pytest.mark.parametrize("cmvn", ["none", "utterance", "global"])
def test_feature_extractor_and_streaming_fbank_match_jax(tmp_path, cmvn):
    data_cfg = {"num_mel_bins": MEL, "normalization": cmvn != "none"}
    if cmvn == "global":
        rng = np.random.default_rng(1)
        np.save(tmp_path / "cmvn.mean.npy", rng.normal(size=MEL).astype(np.float32))
        np.save(tmp_path / "cmvn.std.npy", rng.uniform(0.5, 2, MEL).astype(np.float32))
        data_cfg["global_cmvn"] = str(tmp_path / "cmvn")
    wavs = waves(2, seed=2)
    paths = write_wavs(tmp_path, wavs)
    ex, jex = serve.FeatureExtractor(data_cfg), jax_serve.FeatureExtractor(data_cfg)
    for p in paths:
        np.testing.assert_allclose(ex(p), jex(p), rtol=0, atol=ATOL)
    for w in wavs:
        sfe, jsfe = serve.StreamingFbank(ex, 16000), jax_serve.StreamingFbank(jex, 16000)
        got, want = [], []
        for s in range(0, len(w), 1300):  # frames that do not fall on the 160-sample shift
            x = w[s: s + 1300].astype(np.float32) / 32768.0
            got.append(sfe.feed(x))
            want.append(jsfe.feed(x))
        got.append(sfe.finish())
        want.append(jsfe.finish())
        np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=ATOL)
        if cmvn != "utterance":  # causal CMVN approaches the whole-utterance one
            np.testing.assert_allclose(np.concatenate(got), ex.from_samples(w / 32768.0, 16000),
                                       rtol=0, atol=ATOL)


def test_psf_features_raise(tmp_path):
    """The psf extractor (which raised before it was ported) now gives the
    JAX server's features, offline and through ``StreamingFbank`` (one
    extraction at the end, exact per-utterance CMVN)."""
    data_cfg = {"num_mel_bins": MEL, "normalization": True, "feature_extractor": "psf"}
    ex, jex = serve.FeatureExtractor(data_cfg), jax_serve.FeatureExtractor(data_cfg)
    w = waves(1, seed=4)[0]
    path = write_wavs(tmp_path, [w])[0]
    np.testing.assert_allclose(ex(path), jex(path), rtol=0, atol=ATOL)
    sfe, jsfe = serve.StreamingFbank(ex, 16000), jax_serve.StreamingFbank(jex, 16000)
    got, want = [], []
    for s in range(0, len(w), 1300):
        x = w[s: s + 1300].astype(np.float32) / 32768.0
        got.append(sfe.feed(x))
        want.append(jsfe.feed(x))
    assert sum(len(g) for g in got) == 0
    np.testing.assert_allclose(sfe.finish(), jsfe.finish(), rtol=0, atol=ATOL)


# ------------------------------------------------------------------ batcher
def _answers(batcher, feats):
    got, lock = {}, threading.Lock()

    def reply(utt, text):
        with lock:
            got[utt] = text

    batcher.start()
    for i, x in enumerate(feats):
        batcher.submit(jax_serve._Request(f"u{i}", x, reply) if isinstance(batcher, jax_serve.DynamicBatcher)
                       else serve._Request(f"u{i}", x, reply))
    batcher.drain_and_stop()
    return got


def test_dynamic_batcher_answers_as_jax_batcher():
    """Seven requests of 40-230 frames through batches of 3 rows (padding
    rows included) and buckets 64/128 (230 frames go beyond the largest and
    round to 256): the port's texts equal JAX's batcher's."""
    model, params = seeded(S2T_CFG, 3)
    idx2unit = {i: f"u{i}" for i in range(V)}
    rng = np.random.default_rng(4)
    feats = [rng.normal(size=(t, MEL)).astype(np.float32) for t in (40, 97, 64, 230, 71, 55, 128)]
    args = {"beam_width": 3, "max_len": 6, "penalty": 0.6}
    rec = build_recognizer("speech2text", model, args=args, idx2unit=idx2unit)
    batcher = serve.DynamicBatcher(rec, [64, 128], max_batch=3, timeout_ms=50.0)
    got = _answers(batcher, feats)
    jm = jax_build_model(S2T_CFG)
    jrec = jax_build_recognizer("speech2text", jm, jax.tree_util.tree_map(jnp.asarray, params),
                                args=args, idx2unit=idx2unit)
    want = _answers(jax_serve.DynamicBatcher(jrec, [64, 128], max_batch=3, timeout_ms=50.0), feats)
    assert got == want and len(got) == 7 and any(got.values())
    stats = batcher.stats()
    assert stats["requests"] == 7 and stats["batches"] >= 3
    assert {"latency_ms_p50", "latency_ms_p90", "latency_ms_p99", "rtfx_served"} <= set(stats)
    assert batcher.bucket_for(230) == 256


def test_dynamic_batcher_raises_a_failed_batch_at_stop():
    class Broken:
        model = torch.nn.Linear(1, 1)

        def recognize(self, feats, mask):
            raise RuntimeError("device lost")

    batcher = serve.DynamicBatcher(Broken(), [64], max_batch=2)
    with pytest.raises(RuntimeError, match="1 batches failed"):
        _answers(batcher, [np.zeros((10, MEL), np.float32)])


# ---------------------------------------------------------------- serve CLI
def start(argv):
    """The serve CLI in a thread on a free port → (server, thread, result)."""
    return chip_smoke.start_server(argv + ["--port", "0", "--device", "cpu"])


def stop(srv, thread, result):
    srv.shutdown()
    thread.join(TIMEOUT)
    assert not thread.is_alive() and result.get("rc") == 0, result.get("error")


def read_lines(sock, until):
    lines, buf = [], b""
    while not until(lines):
        more = sock.recv(65536)
        if not more:
            break
        buf += more
        *done, buf = buf.split(b"\n")
        lines += [d.decode() for d in done]
    return lines


@pytest.fixture(scope="module")
def s2t_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("s2t")
    npz, conf, model, _ = checkpoint(str(root), S2T_CFG, {"num_mel_bins": MEL,
                                                          "normalization": True}, seed=5)
    paths = write_wavs(str(root / "wavs"), waves(5, seed=6))
    return root, npz, conf, model, paths


def offline_texts(model, conf, feats, max_batch=4, bucket=200):
    """The port's own decode of each utterance, padded as the batcher pads
    it (one row of a ``max_batch``-row batch at ``bucket`` frames)."""
    rec = build_recognizer("speech2text", model, args={"beam_width": 3, "max_len": 8},
                           idx2unit=idx2unit_of(conf))
    out = []
    for x in feats:
        batch = np.zeros((max_batch, bucket, MEL), np.float32)
        batch[0, : len(x)] = x
        mask = np.arange(bucket)[None] < np.array([len(x)] + [1] * (max_batch - 1))[:, None]
        out.append(rec.recognize(torch.from_numpy(batch), torch.from_numpy(mask))[0][0][0])
    return out


def test_serve_cli_file_mode_and_tcp_lines(s2t_ckpt):
    root, npz, conf, model, paths = s2t_ckpt
    flags = ["--npz", npz, "--model_cfg", conf, "-bw", "3", "-ml", "8", "--max-batch", "4",
             "--bucket-frames", "200"]
    out = str(root / "answers.txt")
    assert serve.main(flags + ["-i", str(root / "wavs" / "wav.scp"), "-o", out,
                               "--device", "cpu"]) == 0
    with open(out) as f:
        answers = dict(line.rstrip("\n").split("\t") for line in f)
    ex = serve.FeatureExtractor({"num_mel_bins": MEL, "normalization": True})
    want = offline_texts(model, conf, [ex(p) for p in paths])
    assert [answers[f"utt{i}"] for i in range(len(paths))] == want and any(want)

    srv, thread, result = start(flags)
    try:
        with socket.create_connection(srv.server_address, timeout=TIMEOUT) as sock:
            sock.sendall("".join(f"utt{i} {p}\n" for i, p in enumerate(paths)).encode())
            sock.sendall(b"bad_line_without_path\n")
            sock.shutdown(socket.SHUT_WR)
            lines = read_lines(sock, lambda got: len(got) == len(paths))
    finally:
        stop(srv, thread, result)
    assert dict(line.split("\t") for line in lines) == answers
    assert srv.batcher.stats()["requests"] == len(paths)


@pytest.fixture(scope="module")
def ctc_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctc")
    npz, conf, model, _ = checkpoint(str(root), CTC_CFG, {"num_mel_bins": MEL,
                                                          "normalization": True}, seed=7)
    paths = write_wavs(str(root / "wavs"), waves(4, seed=8, min_s=1.0, max_s=2.5))
    return root, npz, conf, model, paths


def greedy_text(model, conf, feats):
    """The port's offline greedy CTC of features at their length, every
    collapsed id written out (as the streaming recognizers write them: the
    offline ``translate`` would stop at an EOS id)."""
    x = torch.from_numpy(feats[None])
    with torch.no_grad():
        ids, mask = model.recognize_argmax(x, torch.ones(x.shape[:2], dtype=torch.bool))
    toks, lens = ctc_collapse_ids(ids, mask)
    idx2unit = idx2unit_of(conf)
    return " ".join(idx2unit[i] for i in toks[0, : int(lens[0])].tolist())


def test_serve_cli_streaming_file_and_tcp_lines(ctc_ckpt, capsys):
    root, npz, conf, model, paths = ctc_ckpt
    flags = ["--npz", npz, "--model_cfg", conf, "--streaming", "--streams", "2"]
    ex = serve.FeatureExtractor({"num_mel_bins": MEL, "normalization": True})
    want = {f"utt{i}": greedy_text(model, conf, ex(p)) for i, p in enumerate(paths)}
    assert any(want.values())
    out = str(root / "stream.txt")
    assert serve.main(flags + ["-i", str(root / "wavs" / "wav.scp"), "-o", out,
                               "--device", "cpu"]) == 0
    with open(out) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert {u: t for u, kind, t in rows if kind == "FINAL"} == want

    srv, thread, result = start(flags)
    try:
        with socket.create_connection(srv.server_address, timeout=TIMEOUT) as sock:
            sock.sendall("".join(f"utt{i} {p}\n" for i, p in enumerate(paths[:2])).encode())
            sock.shutdown(socket.SHUT_WR)
            lines = read_lines(sock, lambda got: sum("\tFINAL\t" in x for x in got) == 2)
    finally:
        stop(srv, thread, result)
    rows = [line.split("\t") for line in lines]
    assert {u: t for u, kind, t in rows if kind == "FINAL"} == {k: want[k] for k in ("utt0",
                                                                                    "utt1")}
    assert "PARTIAL" in [kind for _, kind, _ in rows]


def pcm_stream(port, utt, wav, frame=1600, cut=False):
    """A PCM client: header, frames, the end frame (or, with ``cut``, a
    truncated frame and a disconnect); returns the server's lines."""
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sock:
        sock.sendall(f"PCM {utt} 16000\n".encode())
        for s in range(0, len(wav), frame):
            data = wav[s: s + frame].astype("<i2").tobytes()
            sock.sendall(struct.pack("<I", len(data)) + data)
        if cut:
            sock.sendall(struct.pack("<I", 100) + b"\x00" * 10)
            sock.shutdown(socket.SHUT_WR)
        else:
            sock.sendall(struct.pack("<I", 0))
        return read_lines(sock, lambda got: any("\tFINAL\t" in x for x in got))


def test_serve_cli_concurrent_pcm_streams(ctc_ckpt):
    """Four PCM clients at once on two slots, and one that disconnects
    mid-frame: each FINAL equals the offline greedy of the features the
    server makes of what arrived (``StreamingFbank``, causal CMVN), PARTIAL
    lines come first, and every slot is free afterwards."""
    root, npz, conf, model, paths = ctc_ckpt
    wavs = [siw.read(p)[1] for p in paths]
    srv, thread, result = start(["--npz", npz, "--model_cfg", conf, "--streaming",
                                 "--streams", "2"])
    lines = [None] * 5
    try:
        def client(i):
            lines[i] = pcm_stream(srv.server_address[1], f"pcm{i}", wavs[i % 4], cut=i == 4)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        free = srv.front.ms.free_slots()
    finally:
        stop(srv, thread, result)
    ex = serve.FeatureExtractor({"num_mel_bins": MEL, "normalization": True})
    for i, got in enumerate(lines):
        want = greedy_text(model, conf, chip_smoke.pcm_features(ex, wavs[i % 4], 1600))
        kinds = [line.split("\t")[1] for line in got]
        assert kinds[-1] == "FINAL" and kinds.count("FINAL") == 1
        assert got[-1] == f"pcm{i}\tFINAL\t{want}"
    assert free == 2
    assert any("\tPARTIAL\t" in x for x in lines[0] + lines[1] + lines[2] + lines[3])


# ----------------------------------------------------------------- eval CLI
def write_feats(root, feats, cfg_vocab_root):
    os.makedirs(root, exist_ok=True)
    items = {f"utt{i}": x for i, x in enumerate(feats)}
    write_ark(os.path.join(root, "feats.ark"), items, os.path.join(root, "feats.scp"))
    with open(os.path.join(root, "text"), "w") as f:
        f.write("".join(f"utt{i} u3 u4\n" for i in range(len(feats))))
    return os.path.join(root, "feats.scp"), os.path.join(root, "text")


def predictions(decode_dir):
    with open(os.path.join(decode_dir, "predict.txt")) as f:
        return [line.split(maxsplit=1)[1].strip() if " " in line.strip() else ""
                for line in f]


@pytest.mark.parametrize("mtype", ["ctc", "speech2text"])
def test_eval_cli_online_equals_offline(tmp_path, mtype):
    """Lengths that are multiples of the collate's 32 frames, so that the
    offline batch is unpadded: ``--online`` then equals the offline decode
    (greedy CTC; the attention FINAL equals the beam over the chunked
    memory)."""
    cfg = CTC_CFG if mtype == "ctc" else S2T_CFG
    npz, conf, _, _ = checkpoint(str(tmp_path / "m"), cfg, {"num_mel_bins": MEL}, seed=9)
    rng = np.random.default_rng(10)
    feats = [rng.normal(size=(t, MEL)).astype(np.float32) for t in (64, 96, 128)]
    scp, text = write_feats(str(tmp_path / "d"), feats, tmp_path)
    with open(conf) as f:
        vocab = json.load(f)["data"]["vocab"]
    base = ["--npz", npz, "--model_cfg", conf, "--feats", scp, "--text", text, "--vocab", vocab,
            "-b", "1", "-bw", "1" if mtype == "ctc" else "3", "-ml", "6", "--device", "cpu"]
    assert eval_cli.main(base + ["--decode_dir", str(tmp_path / "off")]) == 0
    assert eval_cli.main(base + ["--decode_dir", str(tmp_path / "on"), "--online"]) == 0
    assert predictions(tmp_path / "on") == predictions(tmp_path / "off")
    assert any(predictions(tmp_path / "on"))


def test_eval_cli_long_form(tmp_path, caplog):
    """``--long_form`` with a 48-frame window over 150-frame inputs equals
    ``LongFormRecognizer``; on a ctc model it warns and decodes offline."""
    npz, conf, model, _ = checkpoint(str(tmp_path / "m"), S2T_CFG, {"num_mel_bins": MEL},
                                     seed=11)
    rng = np.random.default_rng(12)
    feats = [rng.normal(size=(t, MEL)).astype(np.float32) for t in (150, 131)]
    scp, text = write_feats(str(tmp_path / "d"), feats, tmp_path)
    with open(conf) as f:
        vocab = json.load(f)["data"]["vocab"]
    common = ["--feats", scp, "--text", text, "--vocab", vocab, "-b", "1", "-ml", "6",
              "--device", "cpu"]
    assert eval_cli.main(["--npz", npz, "--model_cfg", conf, *common, "-bw", "3", "--long_form",
                          "--window", "48", "--context", "8",
                          "--decode_dir", str(tmp_path / "long")]) == 0
    rec = LongFormRecognizer(model, beam_width=3, max_len=6, window=48, context=8,
                             idx2unit=idx2unit_of(conf))
    want = [rec.recognize(torch.from_numpy(x[None]), torch.ones(1, len(x), dtype=torch.bool))[0][0][0]
            for x in feats]
    assert predictions(tmp_path / "long") == want

    cnpz, cconf, _, _ = checkpoint(str(tmp_path / "c"), CTC_CFG, {"num_mel_bins": MEL}, seed=13)
    ctc_common = ["--npz", cnpz, "--model_cfg", cconf, *common, "-bw", "1"]
    assert eval_cli.main(ctc_common + ["--decode_dir", str(tmp_path / "c_off")]) == 0
    with caplog.at_level("WARNING"):
        assert eval_cli.main(ctc_common + ["--long_form", "--decode_dir",
                                           str(tmp_path / "c_long")]) == 0
    assert "only applies to speech2text" in caplog.text
    assert predictions(tmp_path / "c_long") == predictions(tmp_path / "c_off")


def test_postprocess_matches_jax():
    from opentransformer_tpu.cli.eval import postprocess as jax_postprocess

    for text, p2w in (("a b <PESN> c", False), ("▁he llo ▁wor ld", True), ("", True)):
        assert eval_cli.postprocess(text, p2w) == jax_postprocess(text, p2w)


def test_memory_search_is_what_the_batcher_decodes_with():
    """The batcher's recognizer searches with ``make_memory_search``: one
    decode of a padded batch equals the search over the encoded memory."""
    model, _ = seeded(S2T_CFG, 14)
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(2, 64, MEL)).astype(np.float32))
    mask = torch.arange(64)[None] < torch.tensor([[64], [40]])
    rec = build_recognizer("speech2text", model, args={"beam_width": 3, "max_len": 5})
    with torch.no_grad():
        mem, mm = model.encode(x, mask)
    assert torch.equal(rec.recognize_arrays(x, mask).tokens,
                       make_memory_search(model, 3, 5)(mem, mm).tokens)
