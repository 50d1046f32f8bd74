"""ssm_chain_roofline.prefill: the share of their roofline that the
Mamba-2 chain kernels (conv_silu before the SSD scan, gated_rmsnorm
after it) reached in the traced generate calls, counted by the program's
span counter of chain launches (bench.chain_roofline), in %."""
from bench import chain_roofline


def read(ctx):
    return chain_roofline.share(ctx)
