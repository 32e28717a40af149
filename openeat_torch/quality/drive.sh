#!/usr/bin/env bash
# Runs a quality drive (run_recipe.sh, or with --script another drive
# of this directory, run_streaming.sh or run_moe.sh) one stage at a time and copies
# its small files into OUT after every stage, so that what a finished
# stage wrote survives a run that is cut later: results*.json,
# cer_*.txt, hyp_*.txt, metrics.jsonl, train.json, the epoch_N.json
# infos, the LM's infos, the derived conf_*.json, cmvn.json,
# stage_times.tsv, the stage log (stages.log) and the machine
# (machine.txt: the card's name and power limit, Python, torch and
# CUDA). The checkpoints stay in WORK. A failed stage, the gate's
# included, ends the drive with its exit code after its files are
# copied, as the drive itself stops at it.
#
# Usage: bash openeat_torch/quality/drive.sh [--script SCRIPT] WORK ARG \
#            OUT FIRST LAST [SCRIPT options...]
#   SCRIPT: run_recipe.sh (default; ARG is its PROFILE),
#           run_streaming.sh or run_moe.sh (ARG is its CORPUS_WORK)
set -uo pipefail

script=run_recipe.sh
if [ "${1:-}" = --script ]; then
  script=$2
  shift 2
fi
work=$1
arg=$2
out=$3
first=$4
last=$5
shift 5
here="$(cd "$(dirname "$0")" && pwd)"
mkdir -p "$out" "$work"
work="$(cd "$work" && pwd)"
log=$out/stages.log

{
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python -c 'import sys, torch; print(sys.version.split()[0],
torch.__version__, torch.version.cuda)'
  echo "cpus $(nproc)"
} > "$out/machine.txt" 2>&1

copy_small() {
  local e=$work/exp f
  for f in "$work"/stage_times.tsv "$work"/conf_*.json "$work"/cmvn.json \
      "$e"/results*.json \
      "$e"/cer_*.txt "$e"/hyp_*.txt "$e"/metrics.jsonl "$e"/train.json \
      "$e"/epoch_*.json "$e"/avg_best*.json; do
    [ -f "$f" ] && cp -f "$f" "$out"/
  done
  if [ -d "$e/lm" ]; then
    mkdir -p "$out/lm"
    for f in "$e"/lm/*.json "$e"/lm/metrics.jsonl; do
      [ -f "$f" ] && cp -f "$f" "$out/lm"/
    done
  fi
  return 0
}

for s in $(seq "$first" "$last"); do
  echo "### stage $s start $(date +%s.%N)" >> "$log"
  bash "$here/$script" --stage "$s" --stop_stage "$s" "$@" \
    "$work" "$arg" >> "$log" 2>&1
  rc=$?
  echo "### stage $s end $(date +%s.%N) rc $rc" >> "$log"
  copy_small
  [ "$rc" -eq 0 ] || exit "$rc"
done
