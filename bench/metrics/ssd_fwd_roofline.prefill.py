"""ssd_fwd_roofline.prefill: the share of its roofline that the ssd_fwd
kernels reached in the traced generate calls (bench.roofline), in %."""
from bench import roofline


def read(ctx):
    return roofline.share(ctx, "ssd_fwd") if ctx.kind == "serve" else None
