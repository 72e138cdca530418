"""SimNet in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package `repro` (which stays the reference). Layout and
names mirror it module for module (``repro_torch/core/simulator.py`` is the
counterpart of ``repro/core/simulator.py``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; there is no silent CPU fallback.
This package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: what it needs from the reference's framework-free modules (the
DES, the feature schema) it keeps as its own copies.
"""
