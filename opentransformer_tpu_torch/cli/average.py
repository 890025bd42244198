"""Checkpoint-averaging CLI (counterpart of ``opentransformer_tpu/cli/average.py``).

    python -m opentransformer_tpu_torch.cli.average EXPDIR START END

averages the parameters of ``model.epoch.START`` … ``model.epoch.END``
(those present) into ``EXPDIR/model.average.fromSTARTtoEND/params.npz``,
which the eval CLI decodes (``--npz``, with ``--model_cfg EXPDIR/config.json``),
and prints its path.
"""

from __future__ import annotations

import argparse

from ..train.checkpoint import Checkpointer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Average checkpoints over an epoch range")
    p.add_argument("expdir", type=str)
    p.add_argument("start_epoch", type=int)
    p.add_argument("end_epoch", type=int)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    print(Checkpointer(args.expdir).average(args.start_epoch, args.end_epoch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
