"""Overlap-scheduled pipeline parallelism on torch.distributed."""
