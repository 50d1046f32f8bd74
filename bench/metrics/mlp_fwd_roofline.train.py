"""mlp_fwd_roofline.train: the share of its roofline that the mlp_fwd kernels
reached in the traced training steps (bench.roofline), in %."""
from bench import roofline


def read(ctx):
    return roofline.share(ctx, "mlp_fwd") if ctx.kind == "train" else None
