"""Plain references of the benchmark's configurations: torch and numpy
only, computed in float32 with TF32 off. They import nothing of the
program and take nothing it made: the harness hands both sides the same
weights, corpus files and generator seeds, and the reference works out
again what the program derives from them (batches, features, draws)."""
