"""idle_pct.<cell kind>: the share of the profiled unit in which no
operation ran on the device (torch.profiler's trace of one unit after the
traced window: its time less the union of its device operations'
intervals). One reader serves every cell kind."""


def read(ctx):
    busy = ctx.profile.get("busy_s")
    if busy is None or not ctx.profile.get("window_s"):
        return None
    return 100.0 * (1.0 - busy / ctx.profile["window_s"])
