#!/usr/bin/env bash
# Short controlled ablations of the flagship recipe on the PyTorch port
# (counterpart of ablate.sh): 3 epochs each of opentransformer_tpu_torch/
# conf/flagship.json with a per-epoch dev loss and greedy-CER probe:
#
#   bf16_noam        - Noam schedule (factor 0.5, warmup 1500, peak ~8.1e-4), bf16
#   f32_noam         - the same schedule in float32 (isolates the dtype)
#   bf16_lr3e4       - the recipe's capped lr, bf16 (isolates the lr)
#   bf16_lr3e4_noaug - capped lr without SpecAugment and load noise
#                      (isolates the augmentation)
#
# Collapse signature: att loss pinned at ~5.2-5.4 and ctc at ~5.73 (the
# unigram prior) with dev greedy CER ~100%. Learning signature: att < 4.5
# and falling and dev CER < 90% by epoch 2.
#
#   bash egs/synth_bench/ablate_torch.sh [outdir]
#
# Environment: DATA (corpus root, default egs/synth_bench/data), DEVICE.
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

outdir=${1:-${TMPDIR:-/tmp}/synth_ablate_torch}
data=${DATA:-egs/synth_bench/data}
dev_args=${DEVICE:+--device $DEVICE}
mkdir -p "$outdir"
conf=opentransformer_tpu_torch/conf/flagship.json

variant() { # name [--set KEY=VALUE ...]
  local name=$1
  shift
  python tools/torch_edit_config.py "$conf" "$outdir/$name.json" --data "$data" \
    --set train.epochs=3 "$@"
}

noam=(--set train.scheduler_type=transformer
      --set 'train.scheduler={"model_size": 256, "warmup_steps": 1500, "factor": 0.5}')
variant bf16_noam "${noam[@]}"
variant f32_noam "${noam[@]}" --set train.dtype=float32
variant bf16_lr3e4
variant bf16_lr3e4_noaug --set data.spec_augment=false --set data.additive_noise_std=0.0

for name in bf16_noam f32_noam bf16_lr3e4 bf16_lr3e4_noaug; do
  echo "=== ablation: $name ==="
  python -m opentransformer_tpu_torch.cli.run -c "$outdir/$name.json" --expdir "$outdir/exp_$name" \
    --log_interval 50 $dev_args 2>&1 | grep -E "Training-Epoch|dev loss|dev greedy|parameters" \
    | tee "$outdir/$name.summary"
done
echo "=== done; summaries in $outdir/*.summary ==="
