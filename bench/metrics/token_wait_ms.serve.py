"""token_wait_ms.serve: host ms an engine.readback span of the program:
the wait for a sampled token to reach the host."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "engine.readback",
                                name="engine.readback")
