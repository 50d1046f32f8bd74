"""mfu.train: model FLOPs of the traced steps (bench.work.train_step_flops:
3 x the forward's matrix products, SSM recurrence and causal attention
products; no recompute) over the traced window x the bf16 peak, in %."""
from bench import work


def read(ctx):
    if not ctx.traced or ctx.kind != "train":
        return None
    t = ctx.traffic
    flops = work.train_step_flops(ctx.cfg, t["batch"], t["seq"])
    return (100.0 * flops * ctx.traced_units
            / (ctx.traced["window_s"] * work.PEAK_FLOPS))
