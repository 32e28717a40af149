# Stage helpers of the quality drives (run_recipe.sh, run_streaming.sh),
# sourced after the drive has set $stage, $stop_stage, $times (the
# stage_times.tsv path) and $exp_dir.

current=0
begin() {  # begin N TEXT: announce stage N
  current=$1
  echo "=== stage $1: $2 ==="
}

# timed LABEL CMD...: run CMD and append "STAGE<TAB>LABEL<TAB>seconds"
# to $times
timed() {
  local label=$1 t0 t1
  shift
  t0=$(date +%s.%N)
  "$@"
  t1=$(date +%s.%N)
  printf '%s\t%s\t%s\n' "$current" "$label" \
    "$(awk -v a="$t0" -v b="$t1" 'BEGIN { printf "%.1f", b - a }')" \
    >> "$times"
}

run_stage() {  # run_stage N: whether stage N is in [stage, stop_stage]
  [ "$stage" -le "$1" ] && [ "$stop_stage" -ge "$1" ]
}

score() {  # score TAG: test CER of exp/hyp_TAG.txt into exp/cer_TAG.txt
  python -m openeat_torch.tools.compute_wer data/test/text \
    "$exp_dir/hyp_$1.txt" > "$exp_dir/cer_$1.txt"
  tail -1 "$exp_dir/cer_$1.txt"
}
