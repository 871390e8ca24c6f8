"""PyTorch and CUDA port of ``unified_video_action_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX package, which stays the reference: this
one imports ``torch`` and numpy, never JAX, and nothing of the JAX package.
Module names mirror the JAX package's (``models/``, ``ops/``, ``policy/``,
``utils/``, ``data/``, ``training/``). The hand-written kernels live in ``csrc/`` and are
built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
