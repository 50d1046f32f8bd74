"""first_token_ms.serve: host ms a generate call of the program spends
in engine.first_token: from the call's start until the first sampled
token is on the host."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "engine.generate",
                                name="engine.first_token")
