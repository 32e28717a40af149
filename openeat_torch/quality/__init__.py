"""The quality drive of the port: the flagship trained on the structured
synthetic corpus, decoded, fused with LMs and held to the repo's
quality gate, stage for stage as the JAX side's drive. Counterparts:

- make_structured_corpus.py: benchmarks/make_structured_corpus.py (the
  same bytes at the same arguments);
- confs.py: the config derivations and profile table of
  benchmarks/run_recipe_tpu.sh;
- results.py: that script's inline Python (results.json,
  results_lm.json, results_significance.json,
  results_adversarial.json), plus results_int8.json;
- run_recipe.sh: benchmarks/run_recipe_tpu.sh on openeat_torch.bin.*
  and openeat_torch.tools.*, with --device, --stage/--stop_stage,
  --max_epoch and --base_config. Stage 8 runs
  benchmarks/check_quality_gate.py as it is;
- init_draw.py: bin.train's own initial weights at a seed as an
  epoch-0 checkpoint, for a drive that changes its draw and nothing
  else (no JAX counterpart).

results/h100_lmhard/ holds the drive's small result files from the
card. Nothing here does work at import.
"""
