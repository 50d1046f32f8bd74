"""optimizer_host_ms.train: host ms a training step in the program's
trainer.optimizer span (the AdamW update)."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "trainer.step",
                                name="trainer.optimizer")
