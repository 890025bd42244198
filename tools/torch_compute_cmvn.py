#!/usr/bin/env python
"""Global CMVN statistics (``<prefix>.mean.npy`` / ``<prefix>.std.npy``,
what ``data.global_cmvn`` reads) over a wav.scp or a kaldi feats.scp, with
the port's host features: the kaldi-compatible fbank of each wav, or the
arks as they are. A host tool: it touches no device.

    python tools/torch_compute_cmvn.py wav.scp OUT_PREFIX [--kind wav|feat]
        [--num_mel_bins 40] [--max_utts N]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentransformer_tpu_torch.data.datasets import _read_wav  # noqa: E402
from opentransformer_tpu_torch.data.kaldi_io import load_mat, read_scp  # noqa: E402
from opentransformer_tpu_torch.ops.fbank import fbank_numpy  # noqa: E402


def cmvn_stats(scp: str, kind: str = "wav", num_mel_bins: int = 40,
               max_utts: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """(mean f32[F], std f32[F], frames) over the scp's utterances, summed
    in float64."""
    total = total_sq = None
    count = 0
    for i, (_, rx) in enumerate(read_scp(scp).items()):
        if max_utts and i >= max_utts:
            break
        if kind == "wav":
            sr, wav = _read_wav(rx)
            feat = fbank_numpy(wav, sample_freq=sr, num_mel_bins=num_mel_bins)
        else:
            feat = load_mat(rx)
        s, sq = feat.sum(axis=0).astype(np.float64), (feat ** 2).sum(axis=0).astype(np.float64)
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += feat.shape[0]
    if not count:
        raise SystemExit(f"error: no frames in {scp}")
    mean = (total / count).astype(np.float32)
    var = np.maximum(total_sq / count - mean.astype(np.float64) ** 2, 1e-10)
    return mean, np.sqrt(var).astype(np.float32), count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Global CMVN over a wav.scp or feats.scp")
    p.add_argument("scp", help="wav.scp or feats.scp")
    p.add_argument("out_prefix", help="writes <prefix>.mean.npy and <prefix>.std.npy")
    p.add_argument("--kind", choices=["wav", "feat"], default="wav")
    p.add_argument("--num_mel_bins", type=int, default=40)
    p.add_argument("--max_utts", type=int, default=0)
    args = p.parse_args(argv)
    mean, std, count = cmvn_stats(args.scp, args.kind, args.num_mel_bins, args.max_utts)
    np.save(args.out_prefix + ".mean.npy", mean)
    np.save(args.out_prefix + ".std.npy", std)
    print(f"cmvn over {count} frames -> {args.out_prefix}.{{mean,std}}.npy")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
