"""serve_tokens_per_s: prompt plus generated tokens of every generate
call in the window over the host time from the first call's start to the
last call's return."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.ends:
        return None
    return len(ctx.ends) * ctx.tokens_per_unit / (ctx.ends[-1] - ctx.starts[0])
