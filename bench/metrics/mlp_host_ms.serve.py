"""mlp_host_ms.serve: host ms a decode step in the program's model.mlp
spans inside engine.decode (every layer's norm, fused MLP and residual
add)."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "engine.decode", name="model.mlp",
                                under="engine.decode")
