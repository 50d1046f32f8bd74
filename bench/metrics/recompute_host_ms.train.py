"""recompute_host_ms.train: host ms a training step in the program's
trainer.recompute spans (each layer's checkpointed forward run again
inside the backward), on every thread."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "trainer.step",
                                name="trainer.recompute")
