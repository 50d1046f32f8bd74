"""attn_host_ms.serve: host ms a decode step in the program's
model.attention spans inside engine.decode (every layer's norm, decode
attention over the KV cache and residual add)."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "engine.decode", name="model.attention",
                                under="engine.decode")
