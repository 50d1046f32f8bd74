"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper GPUs: the LM
substrate (models, kernels, training, serving, mesh, dry-run) and the
Fast-OverlaPIM mapper (``core/``, ``dse/``, ``obs/``, ``workloads/`` and
``serve``'s ``MappingService``), which stays numpy.

Imports ``torch``, numpy and the stdlib only -- never ``jax`` and
nothing of ``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``; the CUDA kernels under ``kernels/`` are built from
``csrc/`` at first use.
"""
