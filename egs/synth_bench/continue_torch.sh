#!/usr/bin/env bash
# Continue flagship training on the PyTorch port at a decayed constant lr
# (1e-4, opentransformer_tpu_torch/conf/flagship_cont.json) from the newest
# checkpoint in the expdir, then average, decode and export the final window
# (counterpart of continue.sh).
#
#   bash egs/synth_bench/continue_torch.sh [end_epoch]
#
# end_epoch (default 40, exclusive, as train.epochs) sizes the continuation;
# the averaging window is the last 5 trained epochs. The weights are
# exported to $EXPDIR/flagship_synth_f16.npz. Environment: DATA (corpus
# root, default egs/synth_bench/data), EXPDIR (default
# egs/synth_bench/exp_torch), DEVICE (e.g. cpu; default the card).
set -euo pipefail
cd "$(dirname "$0")/../.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

end_epoch=${1:-40}
data=${DATA:-egs/synth_bench/data}
expdir=${EXPDIR:-egs/synth_bench/exp_torch}
dev_args=${DEVICE:+--device $DEVICE}
avg_to=$((end_epoch - 1))
avg_from=$((end_epoch - 5))

tmpconf=$(mktemp "${TMPDIR:-/tmp}/flagship_cont_XXXX.json")
python tools/torch_edit_config.py opentransformer_tpu_torch/conf/flagship_cont.json "$tmpconf" \
  --set "train.epochs=${end_epoch}" --data "$data"

echo "=== continue: epochs ..${avg_to} at lr 1e-4 (conf: $tmpconf) ==="
python -m opentransformer_tpu_torch.cli.run -c "$tmpconf" --expdir "$expdir" --log_interval 50 -ct $dev_args

echo "=== average ${avg_from}-${avg_to} ==="
python tools/torch_average.py "$expdir" "$avg_from" "$avg_to"

echo "=== decode test split ==="
python -m opentransformer_tpu_torch.cli.eval -m "$expdir/model.average.from${avg_from}to${avg_to}" \
  -bw 5 -pn 0.6 -ml 32 -b 100 -d test $dev_args
cat "$expdir"/decode_test_bw5_pn0.6_ml32_avg${avg_from}-${avg_to}/RESULT

echo "=== export trained weights ==="
python tools/torch_export_trained_synth.py \
  "$expdir/model.average.from${avg_from}to${avg_to}" "$expdir/flagship_synth_f16.npz" \
  --result "$expdir/decode_test_bw5_pn0.6_ml32_avg${avg_from}-${avg_to}/RESULT" \
  --embed-model-cfg --regenerate "bash egs/synth_bench/run_torch.sh"
