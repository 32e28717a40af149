#!/usr/bin/env bash
# The quality drive on openeat_torch: the structured synthetic corpus,
# trained and decoded through the recipe's CLIs, stage for stage as
# benchmarks/run_recipe_tpu.sh:
#   0 corpus (openeat_torch.quality.make_structured_corpus)
#   1 dict + manifests
#   2 train (static 64-utterance batches; resumes from the newest
#     epoch_N.pt)
#   3 average the best 3 epochs by cv loss
#   4 decode test in the four modes (batch 64, beam 10) + CER
#   5 LMs: KN ARPA and the transformer LM on data/lm_text/text where
#     the profile has it (else data/train/text)
#   6 attention rescoring with n-gram and with transformer-LM fusion,
#     and with int8 weights (results_int8.json, outside the gate)
#   7 paired significance of the mode deltas
#   8 (lmhard) benchmarks/check_quality_gate.py, as a process: a failed
#     gate ends the script with exit 1
#   9 (lmhard) the adversarial splits test_reverb and test_long
# Results land in WORK/exp/results*.json, each command's seconds in
# WORK/stage_times.tsv.
#
# Usage: bash openeat_torch/quality/run_recipe.sh [options] WORK [PROFILE]
#   PROFILE: v1 (default), hard or lmhard
#   --device cuda|cpu    (default cuda; passed to every CLI that runs a
#                         model; cuda raises without a card)
#   --stage N --stop_stage M   (default 0 and 9)
#   --max_epoch N        (default 60)
#   --base_config YAML   (default examples/aishell/conf/
#                         train_conformer_tpu.yaml)
#   --corpus_opts "..."  (extra flags for the corpus builder, e.g.
#                         "--n_train 16 --n_dev 4 --n_test 8
#                          --lm_text_n 200 --n_adv 4")
set -euo pipefail

stage=0
stop_stage=9
device=cuda
max_epoch=60
repo_root="$(cd "$(dirname "$0")/../.." && pwd)"
base_config=$repo_root/examples/aishell/conf/train_conformer_tpu.yaml
corpus_opts=""
beam_size=10
ctc_weight=0.5
reverse_weight=0.3
average_num=3
lm_weight=0.3
decode_batch_size=64
export PYTHONPATH="$repo_root:${PYTHONPATH:-}"

. "$repo_root/tools/parse_options.sh" || exit 1

work=${1:-recipe_quality}
profile=${2:-v1}
eval "$(python -m openeat_torch.quality.confs profile "$profile")"
# the stages run inside WORK: resolve a path given relative to here
base_config=$(realpath "$base_config")
mkdir -p "$work"
work="$(cd "$work" && pwd)"
cd "$work"
exp_dir=$work/exp
avg=$exp_dir/avg_best${average_num}.pt
times=$work/stage_times.tsv

# a work dir is bound to ONE corpus profile: reusing a corpus under
# another label would mislabel every result
if [ -f data/.corpus_profile ] && \
   [ "$(cat data/.corpus_profile)" != "$profile" ]; then
  echo "ERROR: $work was generated with profile" \
       "'$(cat data/.corpus_profile)', requested '$profile';" \
       "use a fresh work dir" >&2
  exit 1
fi

if [ "$device" != cpu ]; then
  # refuse before the corpus is built, not at the first CLI
  python -c "from openeat_torch.utils.common import resolve_device; \
resolve_device('$device')"
fi

. "$repo_root/openeat_torch/quality/stages.sh"

# decode LABEL SPLIT MODE MAX_HYP RESULT [extra recognize flags...]
decode() {
  local label=$1 split=$2 mode=$3 max_hyp=$4 result=$5
  shift 5
  timed "$label" python -m openeat_torch.bin.recognize \
    --device "$device" \
    --config "$exp_dir/train.json" \
    --checkpoint "$avg" \
    --test_data "data/$split/format.data" \
    --dict data/dict.txt \
    --mode "$mode" \
    --batch_size "$decode_batch_size" --beam_size "$beam_size" \
    --ctc_weight "$ctc_weight" --reverse_weight "$reverse_weight" \
    --max_hyp_len "$max_hyp" \
    --result_file "$result" "$@"
}

if run_stage 0 && [ ! -f data/train/wav.scp ]; then
  begin 0 "corpus [$profile] (10240 train / 512 dev / $n_test test)"
  # shellcheck disable=SC2086
  timed corpus python -m openeat_torch.quality.make_structured_corpus \
    "$work" $corpus_flags $corpus_opts
  echo "$profile" > data/.corpus_profile
fi

if run_stage 1 && [ ! -f data/train/format.data ]; then
  begin 1 "dict + manifests"
  timed dict python -m openeat_torch.tools.build_dict data/train/text \
    data/dict.txt
  for x in train dev test; do
    timed "format_$x" python "$repo_root/tools/format_data.py" data/$x
  done
fi

if run_stage 2 && [ ! -f "$exp_dir/epoch_$max_epoch.pt" ]; then
  begin 2 "train ($max_epoch epochs, static 64-utt batches)"
  python -m openeat_torch.quality.confs train "$base_config" "$profile" \
    "$max_epoch" "$work/conf_synth.json"
  # resume from the newest epoch checkpoint of an interrupted run
  # (bin.train --checkpoint restores the weights, the step and, from
  # optimizer.pt, Adam's moments)
  resume=()
  last=$(find "$exp_dir" -maxdepth 1 -name 'epoch_*.pt' 2>/dev/null |
         sed 's/.*epoch_//; s/\.pt$//' | sort -n | tail -1 || true)
  if [ -n "${last:-}" ]; then
    echo "resuming from epoch_$last"
    resume=(--checkpoint "$exp_dir/epoch_$last.pt")
  fi
  timed train python -m openeat_torch.bin.train \
    --device "$device" \
    --config "$work/conf_synth.json" \
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
  begin 4 "decode (4 modes) + CER"
  for mode in ctc_greedy_search ctc_prefix_beam_search attention \
      attention_rescoring; do
    decode "$mode" test "$mode" 24 "$exp_dir/hyp_${mode}.txt"
    score "$mode"
  done
  python -m openeat_torch.quality.results collect "$exp_dir" \
    "$exp_dir/results.json" ctc_greedy_search ctc_prefix_beam_search \
    attention attention_rescoring
fi

lm_text=data/train/text
[ -f data/lm_text/text ] && lm_text=data/lm_text/text
if run_stage 5; then
  begin 5 "LMs (KN ARPA + transformer) on $lm_text"
  if [ ! -f "$exp_dir/lm.arpa" ]; then
    timed ngram python -m openeat_torch.tools.train_ngram "$lm_text" \
      "$exp_dir/lm.arpa" --order "$ngram_order" --format kaldi \
      --tokenizer char
  fi
  if [ ! -f "$exp_dir/lm/epoch_$lm_epochs.pt" ]; then
    python -m openeat_torch.quality.confs lm \
      "$repo_root/examples/aishell/conf/train_lm.yaml" "$lm_epochs" \
      "$work/conf_lm.json"
    timed train_lm python -m openeat_torch.bin.train_lm \
      --device "$device" \
      --config "$work/conf_lm.json" \
      --train_data "$lm_text" \
      --cv_data data/dev/text \
      --dict data/dict.txt \
      --exp_dir "$exp_dir/lm"
  fi
fi

if run_stage 6; then
  begin 6 "attention_rescoring + LM fusion, and int8"
  decode rescoring_ngram test attention_rescoring 24 \
    "$exp_dir/hyp_rescoring_ngram.txt" \
    --ngram_lm "$exp_dir/lm.arpa" --lm_weight "$lm_weight"
  score rescoring_ngram
  decode rescoring_translm test attention_rescoring 24 \
    "$exp_dir/hyp_rescoring_translm.txt" \
    --lm_config "$work/conf_lm.json" \
    --lm_checkpoint "$exp_dir/lm/epoch_$lm_epochs.pt" \
    --lm_weight "$lm_weight"
  score rescoring_translm
  python -m openeat_torch.quality.results collect "$exp_dir" \
    "$exp_dir/results_lm.json" rescoring_ngram rescoring_translm
  decode rescoring_int8 test attention_rescoring 24 \
    "$exp_dir/hyp_attention_rescoring_int8.txt" --quantize int8
  score attention_rescoring_int8
  python -m openeat_torch.quality.results int8 "$exp_dir" data/test/text
fi

if run_stage 7; then
  begin 7 "paired significance (mode deltas vs noise floor)"
  timed significance python -m openeat_torch.quality.results \
    significance "$exp_dir" data/test/text
fi

if [ "$profile" = lmhard ]; then
  if run_stage 8; then
    begin 8 "executable quality gate"
    timed gate python "$repo_root/benchmarks/check_quality_gate.py" \
      "$exp_dir"
  fi

  if run_stage 9; then
    begin 9 "adversarial splits (reverb channel + length extrapolation)"
    if [ ! -f data/test_reverb/wav.scp ]; then
      # shellcheck disable=SC2086
      timed corpus_adversarial python -m \
        openeat_torch.quality.make_structured_corpus "$work" \
        --profile lmhard --only_adversarial $corpus_opts
    fi
    for x in test_reverb test_long; do
      [ -f data/$x/format.data ] || \
        python "$repo_root/tools/format_data.py" data/$x
    done
    for split in test_reverb test_long; do
      max_hyp=24
      [ "$split" = test_long ] && max_hyp=32
      for mode in ctc_greedy_search attention_rescoring; do
        decode "${split}_$mode" "$split" "$mode" "$max_hyp" \
          "$exp_dir/hyp_${split}_${mode}.txt"
      done
      decode "${split}_rescoring_ngram" "$split" attention_rescoring \
        "$max_hyp" "$exp_dir/hyp_${split}_rescoring_ngram.txt" \
        --ngram_lm "$exp_dir/lm.arpa" --lm_weight "$lm_weight"
    done
    timed adversarial_scores python -m openeat_torch.quality.results \
      adversarial "$exp_dir" data
  fi
fi
