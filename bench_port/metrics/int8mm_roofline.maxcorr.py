"""int8mm_roofline.maxcorr: the share of its roofline of the MaxCorrs
scan's int8 product (`torch._int_mm`, one a group of tile pairs), over
the window's products (bench_port.roofline.share)."""
from bench_port.roofline import share


def read(ctx):
    return share(ctx, "maxcorr_product", "maxcorr_products")
