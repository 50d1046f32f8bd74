"""step_wait_ms.train: host ms a training step in the program's
trainer.sync span: the end-of-step synchronise, where the host waits for
the card."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "trainer.step", name="trainer.sync")
