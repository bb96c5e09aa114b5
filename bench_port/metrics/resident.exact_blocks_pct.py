"""resident.exact_blocks_pct: the share of the resident sweeps' blocks
that ran through the exact band on kernels F and G
(`exact_blocks_run["cuda"]`) among all blocks run (with the block
steps on kernels A and B, counted by a stand-in)."""


def read(ctx):
    ex = ctx.counters["exact_blocks_run"]["cuda"]
    blocks = ctx.block_steps + ex
    if not blocks:
        return None
    return 100.0 * ex / blocks
