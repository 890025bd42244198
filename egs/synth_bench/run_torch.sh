#!/usr/bin/env bash
# Synthetic benchmark recipe at the flagship geometry on the PyTorch port
# (counterpart of run.sh): generate the deterministic corpus
# (opentransformer_tpu_torch/data/synth.py), train the flagship
# speech-transformer (opentransformer_tpu_torch/conf/flagship.json, the JSON
# of conf/flagship.yaml) on the card, then continue_torch.sh: continue at lr
# 1e-4, average the last 5 epochs, decode the test split and export.
#
#   bash egs/synth_bench/run_torch.sh [stage]
#
# Environment: DATA (corpus root, default egs/synth_bench/data), EXPDIR
# (default egs/synth_bench/exp_torch), DEVICE (e.g. cpu; default the card).
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

stage=${1:-0}
data=${DATA:-egs/synth_bench/data}
expdir=${EXPDIR:-egs/synth_bench/exp_torch}
dev_args=${DEVICE:+--device $DEVICE}
conf=$(mktemp "${TMPDIR:-/tmp}/flagship_XXXX.json")
python tools/torch_edit_config.py opentransformer_tpu_torch/conf/flagship.json "$conf" --data "$data"

if [ "$stage" -le 0 ]; then
  echo "=== stage 0: generate corpus (deterministic seeds) ==="
  python -m opentransformer_tpu_torch.data.synth "$data"
fi

if [ "$stage" -le 1 ]; then
  echo "=== stage 1: train flagship (warmup->3e-4 hold, 15 epochs x 312 steps) ==="
  python -m opentransformer_tpu_torch.cli.run -c "$conf" --expdir "$expdir" --log_interval 50 $dev_args
fi

if [ "$stage" -le 2 ]; then
  echo "=== stage 2: continue at lr 1e-4 to epoch 40, average 35-39, decode, export ==="
  DATA="$data" EXPDIR="$expdir" bash egs/synth_bench/continue_torch.sh 40
fi
