#!/usr/bin/env bash
# AISHELL-1 recipe on the PyTorch port (counterpart of run.sh): stage -1
# download, 0 data prep, 1 vocab (as run.sh: local/*.py import neither
# package), 2 train, 3 average, 4 decode through the port's CLIs with
# opentransformer_tpu_torch/conf/transformer_baseline.json (the
# transformer_baseline YAML as JSON, with on-device feature extraction).
#
#   bash run_torch.sh [stage] [stop_stage]     (from egs/aishell)
#
# Environment: AISHELL_CORPUS (download directory), DEVICE (e.g. cpu;
# default the card).
set -euo pipefail

stage=${1:--1}
stop_stage=${2:-4}
data_url=https://openslr.elda.org/resources/33
corpus=${AISHELL_CORPUS:-downloads}
datadir=data
expdir=exp/transformer_baseline_torch
conf=opentransformer_tpu_torch/conf/transformer_baseline.json
repo_root=$(cd "$(dirname "$0")/../.." && pwd)
dev_args=${DEVICE:+--device $DEVICE}
export PYTHONPATH="$repo_root${PYTHONPATH:+:$PYTHONPATH}"

if [ $stage -le -1 ] && [ $stop_stage -ge -1 ]; then
  echo "stage -1: download AISHELL-1 (OpenSLR-33)"
  mkdir -p "$corpus"
  for f in data_aishell.tgz resource_aishell.tgz; do
    [ -f "$corpus/$f" ] || wget -c -O "$corpus/$f" "$data_url/$f"
  done
  tar -xzf "$corpus/data_aishell.tgz" -C "$corpus"
  # per-speaker inner tarballs
  find "$corpus/data_aishell/wav" -name "*.tar.gz" -execdir tar -xzf {} \; -delete
fi

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  echo "stage 0: data preparation"
  python local/prepare_data.py "$corpus/data_aishell" "$datadir"
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "stage 1: vocab"
  python local/generate_vocab.py "$datadir/train/text" "$datadir/vocab"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "stage 2: train"
  (cd "$repo_root" && python -m opentransformer_tpu_torch.cli.run -c "$conf" \
      --expdir "egs/aishell/$expdir" $dev_args)
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "stage 3: average last 10 epochs"
  (cd "$repo_root" && python tools/torch_average.py "egs/aishell/$expdir" 70 79)
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  echo "stage 4: decode"
  (cd "$repo_root" && python -m opentransformer_tpu_torch.cli.eval \
      -m "egs/aishell/$expdir/model.average.from70to79" -bw 5 -pn 0.6 -ml 60 -d test $dev_args)
fi
