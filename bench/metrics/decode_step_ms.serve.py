"""decode_step_ms.serve: host ms under the spans around the engine's
decode step, over their count (the host issues the step; generate then
waits for its token)."""


def read(ctx):
    span = (ctx.traced or {}).get("spans", {}).get("decode")
    if not span or not span["count"]:
        return None
    return 1e3 * span["host_s"] / span["count"]
