"""B_roofline.resident: the share of its roofline of kernel B (csrc/walk_backtrack.cu) in the resident sweeps,
over the window's launches (bench_port.roofline.share)."""
from bench_port.roofline import share


def read(ctx):
    return share(ctx, "staircase_fill", "walk_backtrack")
