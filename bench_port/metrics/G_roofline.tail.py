"""G_roofline.tail: the share of its roofline of kernel G (csrc/exact_walk.cu) in the anneal tail,
over the window's launches (bench_port.roofline.share)."""
from bench_port.roofline import share


def read(ctx):
    return share(ctx, "exact_fill", "exact_walk")
