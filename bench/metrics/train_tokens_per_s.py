"""train_tokens_per_s: tokens of every step in the window over the host
time from the first step's start to the last one's end (each step ends in
the trainer's synchronise)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.ends:
        return None
    return len(ctx.ends) * ctx.tokens_per_unit / (ctx.ends[-1] - ctx.starts[0])
