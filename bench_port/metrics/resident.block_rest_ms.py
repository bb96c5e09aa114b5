"""resident.block_rest_ms: ms a block of the resident sweeps outside
kernels A, B, F and G: the sweeps' seconds (`resident_sweep_s`, to their
last device sync) less the time inside those kernels (their CUDA
events), over the blocks run (block steps and exact blocks)."""


def read(ctx):
    c = ctx.counters
    blocks = ctx.block_steps + c["exact_blocks_run"]["cuda"]
    if not blocks or not c["resident_sweep_s"]:
        return None
    inside = sum(ctx.kernel_ms.get(k, 0.0) for k in (
        "staircase_fill", "walk_backtrack", "exact_fill", "exact_walk"))
    return (1e3 * c["resident_sweep_s"] - inside) / blocks
