"""kernel_host_ms.train: host ms a training step in the program's
kernel.* spans (the kernel wrappers' forward and backward Functions), on
every thread, none counted inside another."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "trainer.step", prefix="kernel.")
