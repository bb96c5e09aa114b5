"""Kernel F's arithmetic, held on the CPU.

Kernel F (csrc/exact_fill.cu) fills the exact band a row at a time, in
band coordinates (lane i at column anf(x) + i), on a cluster of CTAs
whose warps run skewed in x. The kernel runs only on the card, so this
file keeps a numpy model of its arithmetic as the kernel splits it:

  * the geometry (`cuda_exact.fill_geometry`): lanes a thread, threads
    and lanes a CTA, CTAs a row, the largest shift a step may take
    without a cluster barrier (a warp's span of lanes);
  * the chunks: a chunk starts at x = 0, after TMAX positions, where the
    band leaves the chunk's staged cost window, and at every step the
    pipeline cannot take (a shift below 0 or past a warp's span, or a
    jump rule whose base is not the carried band start);
  * the staged cost window of a chunk and CTA: six planes (the four
    substitution costs less the gap cost, the insert cost and the gap
    prefix g[y+1]) from the aligned column `cw0`, read at the step's
    offset;
  * the reduced band r = M - g[y+1], in which the jump rule is the
    source lane clamped to W-1, a read below the band is BIG - g, and
    every equality of the plain version is the same test on r;
  * a step inside a chunk reads only its own CTA's lanes and the next
    CTA's strip of one warp (asserted); a chunk's first step reads any
    lane, and g from device memory where the plain version's rules need
    it (a shift below 0, the jump base past a row's end);
  * a row past its end keeps its band frozen and still emits codes;
  * the wide layout (bands past the clustered layout's cap, or asked
    for): every step takes the chunk-first step's rules, and each lane's
    running min is composed as the kernel composes it (its own lanes, its
    warp's scan, the CTA's table of warp minima by group and warp, the
    CTAs below).

The model is held bit-equal to the torch exact band
(ops/banded_realign.banded_fill) and, at the smaller bands, to the JAX
package's `banded_fill`, on blocks with every kind of shift, rows that
end mid-chunk, rows of length 0 and 1, padding columns, ways that are
not edge-padded across x = 256, and bands 16, 1,000 (at 1, 2, 4 and 8
CTAs a row), 4,200, 8,192 and the cap; the wide layout at bands 16,
1,000, 16,392 and 20,000.
Change it with the kernel.
"""
import numpy as np
import pytest
import torch
from repeatresolver_tpu.ops import banded_realign as jbr

from repeatresolver_tpu_torch.ops import banded_realign as pbr
from repeatresolver_tpu_torch.ops import cuda_exact as ce
from tests.test_torch_cuda_kernels import exact_shift_inputs, unpad_ways

BIG = 1 << 30
NEUTRAL = (1 << 31) - 1


def wrap(a):
    """int64 values wrapped to int32, as the kernel's sums wrap."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def planes_of(counts, row, cps):
    """The kernel's cost planes of one row, [6, cps] int64 (column y at
    index y + 4): subg_s = sub_s - gapcost (s = 0..3), ins, g[y+1]."""
    cp = counts.shape[0]
    c = counts.astype(np.int64)
    own = row.astype(np.int64)
    bases = c[:, :4].sum(axis=1)
    ns = wrap(bases + c[:, 4] - (own < 5))
    gap = wrap(bases - (own < 4))
    g1 = wrap(np.cumsum(gap))
    pl = np.zeros((6, cps), np.int64)
    for s in range(4):
        pl[s, 4:4 + cp] = wrap(ns - c[:, s] + (own == s) - gap)
    pl[4, 4:4 + cp] = np.maximum(ns, np.concatenate([ns[:1], ns[:-1]]))
    pl[5, 4 + cp:] = g1[-1]
    pl[5, 4:4 + cp] = g1
    return pl, np.concatenate([[0], g1])


def chunk_starts(anf, aprev, gtab, geo):
    """The kernel's chunk starts of a row (its rule, position by
    position)."""
    l = len(anf)
    starts = [0]
    x0 = 0
    for x in range(1, l):
        d = anf[x] - aprev[x]
        regular = (x - x0 < ce.FILL_TMAX and 0 <= d <= geo.span
                   and not (d >= 1 and gtab[x] != aprev[x])
                   and 0 <= anf[x] - anf[x0] <= ce.FILL_SLACK)
        if not regular:
            starts.append(x)
            x0 = x
    return starts


def wide_prefix(av, geo):
    """The wide layout's running min of the candidates av [lanes], as
    the kernel composes it: a thread's four lanes, its warp's inclusive
    scan of the threads' minima (exclusive for the thread), the CTA's
    table of warp minima in (group, warp) order (exclusive), and the
    CTAs below."""
    nw = geo.threads // 32
    a = av.reshape(geo.cs, geo.groups, nw, 32, 4)
    loc = np.minimum.accumulate(a, axis=4)
    xs = np.minimum.accumulate(loc[..., -1], axis=3)
    ex = np.concatenate([np.full(xs.shape[:3] + (1,), NEUTRAL),
                         xs[..., :-1]], axis=3)
    table = xs[..., -1].reshape(geo.cs, -1)
    tab_ex = np.concatenate([np.full((geo.cs, 1), NEUTRAL),
                             np.minimum.accumulate(table, axis=1)[:, :-1]],
                            axis=1).reshape(geo.cs, geo.groups, nw)
    cta = table.min(axis=1)
    cta_ex = np.concatenate([[NEUTRAL], np.minimum.accumulate(cta)[:-1]])
    pre = np.minimum(np.minimum(cta_ex[:, None, None, None],
                                tab_ex[..., None]), ex)
    return np.minimum(pre[..., None], loc).reshape(-1)


def model_row(counts, row, seq, way, length, ncols, w, geo):
    """Kernel F on one row: (codes uint8 [L, W], band int32 [W], anf)."""
    l = len(seq)
    bh = w // 2
    cps = ce.plane_columns(counts.shape[0], geo)
    pl, g = planes_of(counts, row, cps)
    lc, nl = geo.lanes_cta, geo.cs * geo.lanes_cta
    anf = np.maximum(0, way.astype(np.int64) - bh)
    # the carried band start before each step, and the jump rule's base
    aprev = np.zeros(l, np.int64)
    for x in range(1, l):
        aprev[x] = anf[min(x, length) - 1] if length > 0 else 0
    gtab = np.array([aprev[x] if x % 256 == 0 else anf[x - 1]
                     for x in range(l)], np.int64)
    wide = geo.groups > 0
    # the wide layout: every step a chunk's first
    starts = set(range(l)) if wide else set(chunk_starts(anf, aprev, gtab,
                                                         geo))
    lane = np.arange(nl)
    cta = lane // lc
    live = lane < w
    # the band before x = 0 and while frozen: M = 0 at columns 0..
    r = wrap(-g[np.minimum(lane + 1, len(g) - 1)])
    codes = np.zeros((l, w), np.uint8)
    x0 = 0
    for x in range(l):
        if x in starts:
            x0 = x
            cw0 = ((anf[x0] + cta * lc - 1) // 4) * 4   # per CTA
        a, ap = anf[x], aprev[x]
        d = a - ap
        y = a + lane
        wi = y - cw0                                    # window index
        # the clustered layout stages a window; the wide one reads the
        # planes in device memory
        assert wide or ((wi - 1 >= 0).all()
                        and (wi < lc + ce.FILL_SLACK + 4).all())
        col = y + 4                                     # scratch index
        subg = pl[int(seq[x]), col]
        ins = pl[4, col]
        g1 = pl[5, col]                                 # g[y+1]
        g0 = pl[5, col - 1]                             # g[y]
        c0r = wrap(BIG - g0[0])                         # below lane 0
        if x == 0:
            up, dg = wrap(-g1), wrap(-g0)
        elif x != x0:
            # inside a chunk: the source lane clamped to W-1
            assert 0 <= d <= geo.span and not (d >= 1 and gtab[x] != ap)
            ju = np.minimum(lane + d, w - 1)
            jd = np.minimum(lane + d - 1, w - 1)
            # only the own CTA's lanes and the next CTA's strip
            assert (ju < (cta + 1) * lc + geo.span)[live].all()
            up = r[ju]
            dg = np.where(jd < 0, c0r, r[np.maximum(jd, 0)])
        else:
            # a chunk's first step: the plain version's rules in full
            adj = wrap(g[min(ap + w, len(g) - 1)]
                       - g[min(gtab[x] + w, len(g) - 1)])
            top = wrap(r[w - 1] + adj)
            ju, jd = lane + d, lane + d - 1
            gcl = lambda v: g[np.clip(v, 0, len(g) - 1)]   # noqa: E731
            if d >= 0:
                up_in = r[np.clip(ju, 0, nl - 1)]
                dg_in = r[np.clip(jd, 0, nl - 1)]
            else:
                up_in = wrap(r[lane] + gcl(ap + lane + 1) - g1)
                dg_in = wrap(r[np.maximum(lane - 1, 0)] + gcl(ap + lane) - g0)
            up = np.where(ju >= w, top,
                          np.where(ju >= 0, up_in, wrap(BIG - g1)))
            dg = np.where(jd >= w, top,
                          np.where(jd >= 0, dg_in, wrap(BIG - g0)))
        diag = wrap(dg + subg)
        upr = wrap(up + ins)
        bigr = wrap(BIG - g1)
        ok = (y > 0) & (y < ncols - 1)
        av = np.where(y < ncols, np.minimum(diag, np.where(ok, upr, bigr)),
                      bigr)
        av = np.where(live, av, NEUTRAL)
        rn = wide_prefix(av, geo) if wide else np.minimum.accumulate(av)
        left = np.concatenate([[c0r], rn[:-1]])
        gap_hit = rn == left
        if x == length - 1:
            gap_hit |= wrap(rn + g1 - g0) == left
        code = np.where(gap_hit, 0, np.where(rn == diag, 1, 2))
        codes[x] = code[:w]
        if x < length:
            r = rn
    a_f = anf[length - 1] if length >= 1 else 0
    band = wrap(r[:w] + g[np.minimum(a_f + np.arange(w) + 1, len(g) - 1)])
    return codes, band.astype(np.int32), np.int32(a_f)


def model_fill(counts, rows, seqs, ways, lengths, ncols, w, cs=None,
               wide=None):
    geo = ce.fill_geometry(w, cs, wide)
    out = [model_row(counts, rows[b], seqs[b], ways[b], int(lengths[b]),
                     ncols, w, geo) for b in range(len(lengths))]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
            np.array([o[2] for o in out], np.int32))


def model_inputs(seed, b, c, l, w):
    return exact_shift_inputs(seed, b, c, l, w, ce.fill_geometry(w).span)


def _plain(arrays, ncols, w):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    codes, band, anf = pbr.banded_fill(*t, ncols, bandwidth=w)
    return codes.numpy(), band.numpy(), anf.numpy()


def _same(got, ref):
    for name, g_, r_ in zip(("codes", "band", "anf"), got, ref):
        np.testing.assert_array_equal(g_, r_, err_msg=name)


# (seed, rows, columns, positions, band): bands 16 and 1,000 at the
# kernel's auto geometry; positions past 256 for the plain chunk rule
MODEL_CASES = [(1, 4, 200, 64, 16), (2, 6, 600, 150, 64),
               (5, 5, 5000, 300, 1000), (7, 4, 3000, 290, 260)]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_model_matches_plain_and_jax(case):
    *arrays, ncols = model_inputs(*case)
    w = case[-1]
    got = model_fill(*arrays, ncols, w)
    _same(got, _plain(arrays, ncols, w))
    jf = jbr.banded_fill(*arrays, np.int32(ncols), bandwidth=w)
    _same(got, [np.asarray(v) for v in jf])


@pytest.mark.parametrize("case", [(3, 4, 900, 290, 64), (8, 4, 3000, 280, 260)])
def test_model_ways_not_edge_padded(case):
    """Past a row's end the ways move: shifts below 0, jump bases that
    are not the carried band start (x % 256 != 0), chunk starts at each;
    held to both plain versions."""
    *arrays, ncols = model_inputs(*case)
    arrays = unpad_ways(arrays, case[0])
    w = case[-1]
    got = model_fill(*arrays, ncols, w)
    _same(got, _plain(arrays, ncols, w))
    jf = jbr.banded_fill(*arrays, np.int32(ncols), bandwidth=w)
    _same(got, [np.asarray(v) for v in jf])


@pytest.mark.parametrize("w,cs", [(2100, None), (3000, None),
                                  (4200, None), (8192, None),
                                  (ce.MAX_W, None), (1000, 2), (1000, 4),
                                  (1000, 8)])
def test_model_geometries(w, cs):
    """Bands on clusters of 2, 4 and 8 CTAs (a strip of one warp between
    CTAs), band 4,200 and the cap, and band 1,000 at each layout
    chip_smoke.py times: held to the torch exact band."""
    *arrays, ncols = model_inputs(11, 4, 3 * w, 40, w)
    got = model_fill(*arrays, ncols, w, cs)
    _same(got, _plain(arrays, ncols, w))


def test_model_shift_kinds():
    """The cases' steps take every kind of shift the kernel splits: 0,
    1, within a warp's span, past it (a chunk start) and past the
    band."""
    *arrays, ncols = model_inputs(5, 5, 5000, 300, 1000)
    ways, lengths = arrays[3], arrays[4]
    geo = ce.fill_geometry(1000)
    d = np.diff(np.maximum(0, ways - 500), axis=1)
    act = np.arange(1, ways.shape[1])[None, :] < lengths[:, None]
    kinds = {0: d == 0, 1: d == 1, "span": (d > 1) & (d <= geo.span),
             "past span": (d > geo.span) & (d <= 1000),
             "past band": d > 1000}
    for name, m in kinds.items():
        assert (m & act).any(), name


@pytest.mark.parametrize("w,l", [(16, 60), (1000, 290), (ce.MAX_W + 8, 40),
                                 (20000, 40)])
def test_model_wide_layout(w, l):
    """The wide layout, at the clustered layout's bands (asked for) and
    past its cap: held to the torch exact band, and at the smaller bands
    to the JAX package's `banded_fill`."""
    *arrays, ncols = model_inputs(11, 4, 3 * w + 200, l, w)
    if w == 1000:
        arrays = unpad_ways(arrays, 11)
    got = model_fill(*arrays, ncols, w, wide=True)
    _same(got, _plain(arrays, ncols, w))
    if w <= 1000:
        jf = jbr.banded_fill(*arrays, np.int32(ncols), bandwidth=w)
        _same(got, [np.asarray(v) for v in jf])


def test_geometry():
    """Lanes a thread, threads a CTA and CTAs a row for the bands the
    kernel takes, chosen or asked for; the clustered layout's cap is
    16,384 lanes, and past it (or asked for) the wide layout takes any
    band: eight CTAs a row, as many groups of 2,048 lanes a CTA as the
    band needs."""
    assert ce.MAX_W == 16384
    for w, cs, ask in [(16, 1, None), (1000, 1, None), (2048, 1, None),
                       (2049, 2, None), (4096, 2, None), (4097, 4, None),
                       (8192, 4, None), (8193, 8, None), (16384, 8, None),
                       (1000, 2, 2), (1000, 4, 4), (1000, 8, 8)]:
        geo = ce.fill_geometry(w, ask)
        assert geo.cs == cs, w
        assert geo.cs * geo.lanes_cta >= w
        assert geo.threads % 32 == 0 and geo.threads <= 512
        assert (geo.cs - 1) * geo.lanes_cta < w   # the top CTA: a lane
    for w, ask in [(1000, 3), (100, 8), (4200, 8), (16384, 4)]:
        with pytest.raises(ValueError):
            ce.fill_geometry(w, ask)
    with pytest.raises(ValueError):
        ce.fill_geometry(ce.MAX_W + 1, wide=False)
    for w, wide, groups in [(ce.MAX_W + 1, None, 2), (32768, None, 2),
                            (65536, None, 4), (100000, None, 7),
                            (1000, True, 1)]:
        geo = ce.fill_geometry(w, wide=wide)
        assert (geo.cs, geo.threads, geo.groups) == (8, 512, groups), w
        assert geo.lanes_cta == groups * 2048
        assert geo.cs * geo.lanes_cta >= w
