"""optimizer_ms.train: device ms a step of the operations launched under
the span around the program's adamw_update."""


def read(ctx):
    span = (ctx.traced or {}).get("spans", {}).get("adamw_update")
    if not span or span["device_s"] <= 0:
        return None
    return 1e3 * span["device_s"] / span["count"]
