"""backward_host_ms.train: host ms a training step in the program's
trainer.backward span (torch.autograd.grad, which the host waits in while
autograd runs the backward, the remat recompute included)."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "trainer.step", name="trainer.backward")
