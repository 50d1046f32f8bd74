"""idle.train: share of the traced window in which no device operation
ran, in %."""


def read(ctx):
    t = ctx.traced
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
