"""The H100 benchmark of openeat_torch: one cell of BENCHMARK.json a run.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it (spec.py): configs/<file>.json, traffic/<mix>.json,
limits/<cell>.json, metrics/<metric>.py, kinds/<kind>.py. The yardstick
(the corpus generator, the plain reference, the FLOP and byte arithmetic,
the peaks, the trace reduction and the comparison that decides `correct`)
lives here, so that a change to the program cannot move it. Nothing here
imports jax or openeat_tpu.
"""
