"""PyTorch/CUDA port of openeat_tpu for NVIDIA Hopper.

Each module mirrors the file of the same path under ``openeat_tpu/``.
The package imports torch, numpy and scipy only; it never imports jax or
anything of ``openeat_tpu``. The first ported path is offline decode
(``python -m openeat_torch.bin.recognize``).
"""
