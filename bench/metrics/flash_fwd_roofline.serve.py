"""flash_fwd_roofline.serve: the share of its roofline that the flash_fwd kernels
reached in the traced generate calls (bench.roofline), in %."""
from bench import roofline


def read(ctx):
    return roofline.share(ctx, "flash_fwd") if ctx.kind == "serve" else None
