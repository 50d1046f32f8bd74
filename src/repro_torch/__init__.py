"""PyTorch/CUDA port of the JAX LM substrate (``repro``), for NVIDIA
Hopper GPUs.

Imports ``torch``, numpy and the stdlib only -- never ``jax`` and
nothing of ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``; the CUDA kernels under ``kernels/`` are built from
``csrc/`` at first use.
"""
