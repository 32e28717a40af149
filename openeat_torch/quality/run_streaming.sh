#!/usr/bin/env bash
# The streamed quality drive on openeat_torch, step for step as
# benchmarks/run_streaming_hard.sh: a causal static-chunk flagship with
# global CMVN trained on the hard structured corpus, the test set decoded
# offline and streamed, and streamed against offline rescoring by the
# paired bootstrap.
#   1 global CMVN statistics over 2048 train utterances (raw fbank)
#   2 train (confs.py stream: the hard profile's config, causal, static
#     16-frame chunks, warmup 8; --cmvn_file; resumes from the newest
#     epoch_N.pt)
#   3 average the best 3 epochs by cv loss
#   4 offline ctc_greedy_search and attention_rescoring (batch 64, beam
#     10) + CER; a mode whose cer file exists is not decoded again
#   5 stream_recognize: 16 concurrent slots, chunk 16 with 8 left
#     chunks, 400 ms pieces, end-of-stream prefix beam and forward /
#     reverse attention rescoring + CER
#   6 results_streaming.json: the three CERs and streamed against
#     offline rescoring (openeat_torch.tools.compare_wer)
# CORPUS_WORK holds the hard corpus (`run_recipe.sh --stage 0
# --stop_stage 1 CORPUS_WORK hard` builds it); WORK/data links to its
# data/, which is only read. Results land in WORK/exp, each command's
# seconds in WORK/stage_times.tsv.
#
# Usage: bash openeat_torch/quality/run_streaming.sh [options] WORK \
#            CORPUS_WORK
#   --device cuda|cpu    (default cuda; cuda raises without a card,
#                         before any stage runs)
#   --stage N --stop_stage M   (default 1 and 6)
#   --max_epoch N        (default 40)
#   --base_config YAML   (default examples/aishell/conf/
#                         train_conformer_tpu.yaml)
set -euo pipefail

stage=1
stop_stage=6
device=cuda
max_epoch=40
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

if run_stage 1 && [ ! -f cmvn.json ]; then
  begin 1 "global CMVN (raw fbank, 2048 train utterances)"
  timed cmvn python -m openeat_torch.tools.compute_cmvn \
    data/train/format.data "$work/cmvn.json" --max_utts 2048 \
    --device "$device"
fi

if run_stage 2 && [ ! -f "$exp_dir/epoch_$max_epoch.pt" ]; then
  begin 2 "train the causal static-chunk flagship ($max_epoch epochs)"
  python -m openeat_torch.quality.confs stream "$base_config" \
    "$max_epoch" "$work/conf_stream.json"
  resume=()
  last=$(find "$exp_dir" -maxdepth 1 -name 'epoch_*.pt' 2>/dev/null |
         sed 's/.*epoch_//; s/\.pt$//' | sort -n | tail -1 || true)
  if [ -n "${last:-}" ]; then
    echo "resuming from epoch_$last"
    resume=(--checkpoint "$exp_dir/epoch_$last.pt")
  fi
  timed train python -m openeat_torch.bin.train \
    --device "$device" \
    --config "$work/conf_stream.json" \
    --train_data data/train/format.data \
    --cv_data data/dev/format.data \
    --dict data/dict.txt \
    --cmvn_file "$work/cmvn.json" \
    --exp_dir "$exp_dir" "${resume[@]}"
fi

if run_stage 3; then
  begin 3 "average best-$average_num"
  timed average python -m openeat_torch.bin.average_model \
    --exp_dir "$exp_dir" --dst "avg_best${average_num}" \
    --num "$average_num" --val_best
fi

if run_stage 4; then
  begin 4 "offline decode (greedy + rescoring) + CER"
  for mode in ctc_greedy_search attention_rescoring; do
    if [ -s "$exp_dir/cer_offline_${mode}.txt" ]; then
      tail -1 "$exp_dir/cer_offline_${mode}.txt"
      continue
    fi
    timed "offline_$mode" python -m openeat_torch.bin.recognize \
      --device "$device" \
      --config "$exp_dir/train.json" \
      --checkpoint "$avg" \
      --test_data data/test/format.data \
      --dict data/dict.txt \
      --mode "$mode" \
      --batch_size 64 --beam_size 10 \
      --ctc_weight 0.5 --reverse_weight 0.3 --max_hyp_len 24 \
      --result_file "$exp_dir/hyp_offline_${mode}.txt"
    score "offline_$mode"
  done
fi

if run_stage 5; then
  begin 5 "streamed decode (16 concurrent slots, rescoring finals) + CER"
  timed streamed python -m openeat_torch.bin.stream_recognize \
    --device "$device" \
    --config "$exp_dir/train.json" \
    --checkpoint "$avg" \
    --test_data data/test/format.data \
    --dict data/dict.txt \
    --chunk_size 16 --num_left_chunks 8 --piece_ms 400 \
    --slots 16 --final_mode attention_rescoring \
    --beam_size 10 --ctc_weight 0.5 --reverse_weight 0.3 \
    --max_hyp_len 24 --enc_capacity 128 \
    --result_file "$exp_dir/hyp_streamed.txt"
  score streamed
fi

if run_stage 6; then
  begin 6 "streamed vs offline rescoring (paired bootstrap)"
  timed results python -m openeat_torch.quality.results streaming \
    "$exp_dir" data/test/text
fi
