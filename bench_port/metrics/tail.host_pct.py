"""tail.host_pct: the share of the anneal tail's card blocks (blocks 16
and 4) spent on the host: gather, compaction, padding and apply, the
transfers, and the flushes between and after the blocks
(`BatchedRealigner.card_tail_split` over the window)."""


def read(ctx):
    s = ctx.counters["card_tail_split"]
    if not s["s"]:
        return None
    return 100.0 * (s["host_s"] + s["transfer_s"] + s["flush_s"]) / s["s"]
