"""mfu.serve: model FLOPs of the traced generate calls
(bench.work.serve_call_flops) over the traced window x the bf16 peak, in
%."""
from bench import work


def read(ctx):
    if not ctx.traced or ctx.kind != "serve":
        return None
    t = ctx.traffic
    flops = work.serve_call_flops(ctx.cfg, t["batch"], t["prompt"],
                                  t["new_tokens"])
    return (100.0 * flops * ctx.traced_units
            / (ctx.traced["window_s"] * work.PEAK_FLOPS))
