"""Operations, bytes and peaks for the kernels' roofline shares.

A frozen copy of `chip_smoke.py`'s arithmetic (`kernel_bounds` for
kernels A and B, `exact_kernel_bounds` for F and G), so that the
yardstick cannot move with the program. Each function gives the least
time the card could take for one launch's work in ms: the larger of its
operations over the int32 rate and its bytes (each input read once, each
output written once; for a walk, one 32-byte sector of codes a word-row
it walks) over the memory rate.

Peaks (NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit): 3.35 TB/s of HBM; 64 int32 lanes an SM a clock, times the card's
SM count and its `clocks.max.sm`; 1,979 TOP/s int8. Every share is
stated with the card's power limit beside it. `product_bound` is the
int8 product's part of `chip_smoke.maxcorr_bounds`.

With `need=True` (the benchmark's shares) A's and F's work is what the
inputs need, not what the smoke charges a launch: each row's bases
(`lengths`) times the band, where the smoke counts every row at the
block's padded length, and A at its widened window of band + widen x
chunk lanes. The frozen counts (`need=False`) stay for the comparison
with the smoke.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
INT8_OPS_PER_S = 1979e12
# int32 operations of one band cell in the cheapest formulation known
# (diagonal add, its reduced form, insert add, min, reduction add,
# running min, min with the prefix, gap compare, diagonal compare and
# select, gap select, funnel shift of the code word)
FILL_OPS_PER_CELL = 11
# dependent int32 operations of one walk step
WALK_CHAIN_OPS = 6
# int32 operations of the exact band's entry scan a column
ENTRY_OPS_PER_COLUMN = 3


def staircase_bounds(b, l, c, w, t, widen, lengths, sm_count, sm_hz,
                     need=False):
    """Kernels A (staircase_fill) and B (walk_backtrack) on one block:
    {name: bound ms}. b rows, l positions (the block's padded length), c
    columns of the histogram and rows, w the band, t the chunk, widen the
    slack in chunks, lengths the rows' bases; need: A's cells and bytes
    from the rows' bases at band w."""
    w2 = w + widen * t
    nc = -(-l // t)
    lpad = nc * t
    nw = lpad // 16
    int_rate = sm_count * INT32_LANES_PER_SM * sm_hz
    steps = int(sum(int(x) for x in lengths))
    if need:
        cells = steps * w
        bytes_a = (c * 6 * 4 + b * c + steps * 5 + b * 4 + steps * w // 4
                   + b * w * 4 + b * 4)
    else:
        cells = b * lpad * w2
        bytes_a = (c * 6 * 4 + b * c + b * l + b * l * 4 + b * 4
                   + nw * b * w2 * 4 + b * w2 * 4 + b * 4)
    ta = max(FILL_OPS_PER_CELL * cells / int_rate,
             bytes_a / HBM_BYTES_PER_S) * 1e3
    rows_walked = int(sum(-(-int(x) // 16) for x in lengths))
    bytes_b = rows_walked * 32 + b * (4 + 4 + nc * 4) + nw * b * 16 * 4
    tb = max(WALK_CHAIN_OPS * steps / int_rate,
             bytes_b / HBM_BYTES_PER_S) * 1e3
    return {"staircase_fill": ta, "walk_backtrack": tb}


def exact_bounds(b, l, c, cpad, w, lengths, sm_count, sm_hz, need=False):
    """Kernels F (exact_fill) and G (exact_walk) on one launch:
    {name: bound ms}. F: every position's band cells x FILL_OPS_PER_CELL
    against its bytes (need: the rows' bases, not the padded length); G:
    the entry scan's and the walk's operations against the final band,
    the sectors walked, the walked positions' band starts and the
    records."""
    nw = -(-l // 16)
    int_rate = sm_count * INT32_LANES_PER_SM * sm_hz
    steps = int(sum(int(x) for x in lengths))
    if need:
        cells = steps * w
        bytes_f = (c * 6 * 4 + b * c + steps * 5 + b * 4 + steps * w // 4
                   + b * w * 4 + b * 4)
    else:
        cells = b * l * w
        bytes_f = (c * 6 * 4 + b * c + b * l + b * l * 4 + b * 4
                   + nw * b * w * 4 + b * w * 4 + b * 4)
    tf = max(FILL_OPS_PER_CELL * cells / int_rate,
             bytes_f / HBM_BYTES_PER_S) * 1e3
    rows_walked = int(sum(-(-int(x) // 16) for x in lengths))
    bytes_g = (b * w * 4 + rows_walked * 32 + steps * 4 + b * 12
               + nw * b * 16 * 4 + b * 8)
    ops_g = ENTRY_OPS_PER_COLUMN * b * cpad + WALK_CHAIN_OPS * steps
    tg = max(ops_g / int_rate, bytes_g / HBM_BYTES_PER_S) * 1e3
    return {"exact_fill": tf, "exact_walk": tg}


def product_bound(rows_p, t, m):
    """The MaxCorrs scan's int8 product for one group (a seed tile of t
    columns against m partner tiles over rows_p rows of the seed tile's
    window): 2 x rows_p x 5t x 5mt int8 operations against its operands
    in and its int32 result out, in ms."""
    t5, w5 = 5 * t, 5 * m * t
    ops = 2 * rows_p * t5 * w5
    nbytes = (t5 + w5) * rows_p + 4 * t5 * w5
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def share(ctx, fill: str, kernel: str):
    """A kernel's share of its roofline over a traced window's launches
    in %: the least time for the work its inputs need, from each
    launch's recorded shapes and row lengths (`ctx.fills[fill]`, the
    fill's calls, which also carry the walk's shapes), over the time
    inside the kernel (`ctx.kernel_ms`, its CUDA events). None where the
    window launched it never."""
    ms = ctx.kernel_ms.get(kernel, 0.0)
    calls = ctx.fills.get(fill, [])
    if not calls or ms <= 0 or not ctx.sm_hz:
        return None
    bound = 0.0
    for call in calls:
        if fill == "maxcorr_product":
            bound += product_bound(*call)
            continue
        if fill == "exact_fill":
            b, l, c, w, lengths = call
            bd = exact_bounds(b, l, c, c, w, lengths.tolist(), ctx.sm_count,
                              ctx.sm_hz, need=True)
        else:
            b, l, c, w, t, widen, lengths = call
            bd = staircase_bounds(b, l, c, w, t, widen, lengths.tolist(),
                                  ctx.sm_count, ctx.sm_hz, need=True)
        bound += bd[kernel]
    return 100.0 * bound / ms
