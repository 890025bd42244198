"""The work the benchmark counts from shapes: floating-point operations
(2 per multiply-add) and bytes, the same whatever implements them.

The model's products are counted at each utterance's real length, so work
spent on padding is not counted as useful. Attention counts its score and
value products. Training counts three times the forward (forward,
gradients of the activations, gradients of the weights). Peaks are the
published dense rates of one H100 SXM.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # float32 at the TF32 rate
PEAK_BYTES = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4}


def conv_frontend(t: int, f: int, mid: int, out: int, d: int) -> tuple[float, int]:
    """(FLOPs, output frames) of two 3x3 stride-2 convolutions (no time
    padding, frequency padding 1) and the projection to ``d``."""
    t1, f1 = (t - 3) // 2 + 1, (f - 1) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 1) // 2 + 1
    macs = t1 * f1 * mid * 9 + t2 * f2 * out * 9 * mid + t2 * out * f2 * d
    return 2.0 * macs, t2


def attention(tq: int, tk: int, d: int) -> float:
    """Score and value products of one head-split attention, all heads."""
    return 2.0 * 2 * tq * tk * d


def ffn(t: int, d: int, d_ff: int, glu: bool) -> float:
    return 2.0 * t * d * d_ff * (3 if glu else 2)


def transformer_encoder(t: int, d: int, d_ff: int, blocks: int, glu: bool = True) -> float:
    """Post-norm blocks: QKV and output projections, attention, the FFN."""
    per = 2.0 * 4 * t * d * d + attention(t, t, d) + ffn(t, d, d_ff, glu)
    return blocks * per


def decoder_step(rows: int, pos: int, t_mem: int, d: int, d_ff: int, blocks: int,
                 vocab: int, glu: bool = True) -> float:
    """One cached decoder step of ``rows`` hypotheses at position ``pos``
    (pos + 1 keys) over ``t_mem`` memory frames, with the vocabulary
    projection; the cross keys and values are counted by ``cross_kv``."""
    per = (2.0 * 4 * rows * d * d + attention(rows, pos + 1, d)       # self
           + 2.0 * 2 * rows * d * d + attention(rows, t_mem, d)       # cross q, out
           + ffn(rows, d, d_ff, glu))
    return blocks * per + 2.0 * rows * d * vocab


def cross_kv(t_mem: int, d: int, blocks: int) -> float:
    return blocks * 2.0 * 2 * t_mem * d * d


def decoder_forced(u: int, t_mem: int, d: int, d_ff: int, blocks: int, vocab: int,
                   glu: bool = True) -> float:
    """A teacher-forced decoder pass over ``u`` tokens."""
    per = (2.0 * 4 * u * d * d + attention(u, u, d)
           + 2.0 * 2 * u * d * d + cross_kv(t_mem, d, 1) + attention(u, t_mem, d)
           + ffn(u, d, d_ff, glu))
    return blocks * per + 2.0 * u * d * vocab


def conformer_chunk(rows: int, c: int, left: int, d: int, d_ff: int, blocks: int,
                    kernel: int, vocab: int, glu: bool = True) -> float:
    """One streamed chunk of ``c`` frames for ``rows`` streams: two half
    FFNs, QKV, position and output projections, attention over ``left + c``
    keys (content and position terms), the convolution module and the CTC
    projection. The front end is counted by ``conv_frontend``."""
    t = rows * c
    per = (2 * ffn(t, d, d_ff, glu) + 2.0 * 4 * t * d * d + 2.0 * (left + 2 * c - 1) * d * d
           + 2.0 * t * d * (2 * (left + c) + left + 2 * c - 1)   # scores, position, values
           + 2.0 * t * d * 3 * d + 2.0 * t * d * kernel)        # pointwise convs, depthwise
    return blocks * per + 2.0 * t * d * vocab


def topk_bound(n: int, d: int, vocab: int, k: int, dtype: str) -> float:
    """Kernel 1's least time (s): the larger of its operations (2·N·D·V) at
    the peak and its bytes (h, W and bias read once, values and ids
    written once) at the memory rate."""
    e = ESIZE[dtype]
    ops = 2.0 * n * d * vocab
    nbytes = n * d * e + vocab * d * e + vocab * e + n * k * 8
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def fbank_bound(n_frames: int, frame_len: int, n_mel: int, n_fft: int = 512) -> float:
    """Kernel 3's least time (s) from its bytes: the float32 frames read,
    the mel matrix read, the log-mel output written."""
    nbytes = 4 * (n_frames * frame_len + (n_fft // 2 + 1) * n_mel + n_frames * n_mel)
    return nbytes / PEAK_BYTES
