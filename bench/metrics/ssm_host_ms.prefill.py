"""ssm_host_ms.prefill: host ms a generate call of the program spends in
model.ssm spans (every Mamba-2 layer's norm, mixer and residual add, in
the prefill and the decode step)."""
from bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, "engine.generate", name="model.ssm")
