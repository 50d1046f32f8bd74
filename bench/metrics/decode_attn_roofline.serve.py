"""decode_attn_roofline.serve: the share of their roofline that the
decode attention kernels (the split kernel and its combine) reached in
the traced generate calls, counted by the program's span counter of
decode attention launches (bench.decode_roofline), in %."""
from bench import decode_roofline


def read(ctx):
    return decode_roofline.share(ctx)
