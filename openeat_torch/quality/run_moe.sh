#!/usr/bin/env bash
# The mixture-of-experts quality drive on openeat_torch, step for step as
# benchmarks/run_moe_hard.sh: the flagship Conformer with a GShard
# top-2-of-4 encoder feed-forward (static capacity 1.25, Switch aux loss
# at 0.01) trained on the hard structured corpus through the dense hard
# drive's recipe, then decoded greedy and with rescoring.
#   1 conf_moe.json (confs.py moe: the hard profile's config, the MoE
#     keys of train_conformer_moe.yaml, warmup 8)
#   2 train (resumes from the newest epoch_N.pt)
#   3 average the best 3 epochs by cv loss
#   4 ctc_greedy_search and attention_rescoring (batch 64, beam 10) +
#     CER; a mode whose cer file exists is not decoded again
#   5 results_moe.json: the two CERs
# No CMVN stage: the model normalizes each utterance, as the JAX drive's.
# CORPUS_WORK holds the hard corpus (`run_recipe.sh --stage 0
# --stop_stage 1 CORPUS_WORK hard` builds it); WORK/data links to its
# data/, which is only read. Results land in WORK/exp, each command's
# seconds in WORK/stage_times.tsv.
#
# Usage: bash openeat_torch/quality/run_moe.sh [options] WORK CORPUS_WORK
#   --device cuda|cpu    (default cuda; cuda raises without a card,
#                         before any stage runs)
#   --stage N --stop_stage M   (default 1 and 5)
#   --max_epoch N        (default 60)
#   --base_config YAML   (default examples/aishell/conf/
#                         train_conformer_tpu.yaml)
set -euo pipefail

stage=1
stop_stage=5
device=cuda
max_epoch=60
repo_root="$(cd "$(dirname "$0")/../.." && pwd)"
base_config=$repo_root/examples/aishell/conf/train_conformer_tpu.yaml
average_num=3
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"

. "$repo_root/tools/parse_options.sh" || exit 1

if [ "$device" != cpu ]; then
  # refuse before any stage, not at the first CLI
  python -c "from openeat_torch.utils.common import resolve_device; \
resolve_device('$device')"
fi

work=${1:?WORK}
corpus=${2:?CORPUS_WORK}
[ -f "$corpus/data/train/format.data" ] || {
  echo "ERROR: no hard corpus at $corpus (run_recipe.sh --stage 0" \
       "--stop_stage 1 $corpus hard builds it)" >&2
  exit 1
}
if [ "$(cat "$corpus/data/.corpus_profile" 2>/dev/null)" != hard ]; then
  echo "ERROR: $corpus holds no corpus of the hard profile" >&2
  exit 1
fi
base_config=$(realpath "$base_config")
corpus=$(cd "$corpus" && pwd)
mkdir -p "$work"
work="$(cd "$work" && pwd)"
cd "$work"
[ -e data ] || ln -s "$corpus/data" data
exp_dir=$work/exp
avg=$exp_dir/avg_best${average_num}.pt
times=$work/stage_times.tsv

. "$repo_root/openeat_torch/quality/stages.sh"

if run_stage 1; then
  begin 1 "MoE config ($max_epoch epochs)"
  python -m openeat_torch.quality.confs moe "$base_config" "$max_epoch" \
    "$work/conf_moe.json"
fi

if run_stage 2 && [ ! -f "$exp_dir/epoch_$max_epoch.pt" ]; then
  begin 2 "train the MoE flagship ($max_epoch epochs)"
  resume=()
  last=$(find "$exp_dir" -maxdepth 1 -name 'epoch_*.pt' 2>/dev/null |
         sed 's/.*epoch_//; s/\.pt$//' | sort -n | tail -1 || true)
  if [ -n "${last:-}" ]; then
    echo "resuming from epoch_$last"
    resume=(--checkpoint "$exp_dir/epoch_$last.pt")
  fi
  timed train python -m openeat_torch.bin.train \
    --device "$device" \
    --config "$work/conf_moe.json" \
    --train_data data/train/format.data \
    --cv_data data/dev/format.data \
    --dict data/dict.txt \
    --exp_dir "$exp_dir" "${resume[@]}"
fi

if run_stage 3; then
  begin 3 "average best-$average_num"
  timed average python -m openeat_torch.bin.average_model \
    --exp_dir "$exp_dir" --dst "avg_best${average_num}" \
    --num "$average_num" --val_best
fi

if run_stage 4; then
  begin 4 "decode (greedy + rescoring) + CER"
  for mode in ctc_greedy_search attention_rescoring; do
    if [ -s "$exp_dir/cer_${mode}.txt" ]; then
      tail -1 "$exp_dir/cer_${mode}.txt"
      continue
    fi
    timed "$mode" python -m openeat_torch.bin.recognize \
      --device "$device" \
      --config "$exp_dir/train.json" \
      --checkpoint "$avg" \
      --test_data data/test/format.data \
      --dict data/dict.txt \
      --mode "$mode" \
      --batch_size 64 --beam_size 10 \
      --ctc_weight 0.5 --reverse_weight 0.3 --max_hyp_len 24 \
      --result_file "$exp_dir/hyp_${mode}.txt"
    score "$mode"
  done
fi

if run_stage 5; then
  begin 5 "results_moe.json"
  timed results python -m openeat_torch.quality.results moe "$exp_dir"
fi
