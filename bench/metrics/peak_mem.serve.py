"""peak_mem.serve: torch.cuda.max_memory_allocated over the window,
after a reset before it, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
