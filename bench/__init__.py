"""The benchmark of the PyTorch/CUDA port ``repro_torch`` (``run.py``)."""
