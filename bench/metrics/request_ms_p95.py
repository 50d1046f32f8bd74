"""request_ms_p95: the 95th percentile (nearest rank) over every request
(one prompt row) of the window of the time from its batch's send to the
return of its generate call, in ms."""
import math


def read(ctx):
    if ctx.kind != "serve" or not ctx.ends:
        return None
    ms = sorted((e - s) * 1e3 for s, e in zip(ctx.starts, ctx.ends)
                for _ in range(ctx.requests_per_unit))
    return ms[math.ceil(0.95 * len(ms)) - 1]
