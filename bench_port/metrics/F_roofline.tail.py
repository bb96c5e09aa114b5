"""F_roofline.tail: the share of its roofline of kernel F (csrc/exact_fill.cu) in the anneal tail,
over the window's launches (bench_port.roofline.share)."""
from bench_port.roofline import share


def read(ctx):
    return share(ctx, "exact_fill", "exact_fill")
