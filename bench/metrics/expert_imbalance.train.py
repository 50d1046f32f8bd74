"""expert_imbalance.train: the rows of the busiest held expert over the
mean rows of the held experts in the traced training steps, from the
program's moe.rows_by_expert counter (summed over the MoE layers, the
recompute included); 1 is an even load. The first read of a run takes
the counters and empties them; a program without them reads None."""


def read(ctx):
    if not ctx.traced:
        return None
    if not hasattr(ctx, "program_counters"):
        try:
            from repro_torch.launch import spans
        except ImportError:
            spans = None
        if spans is None or not hasattr(spans, "counters"):
            ctx.program_counters = {}
        else:
            ctx.program_counters = spans.counters()
            spans.reset_counters()
    rows = ctx.program_counters.get("moe.rows_by_expert")
    if not rows or not sum(rows):
        return None
    return max(rows) * len(rows) / sum(rows)
