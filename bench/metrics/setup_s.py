"""setup_s: seconds from process start to the first timed unit
(loading, the kernel build when the checkout has none, the weights, the
checked or warm-up units)."""


def read(ctx):
    return ctx.setup_s
