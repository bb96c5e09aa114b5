"""Kernel C's word recurrence, held on the CPU.

Kernel C (csrc/editdp_fill.cu) fills the edit DP of cut and align a
32-column word at a time: Myers' bit-vector recurrence in Hyyrö's block
form, the bits along the target, one step a query row. The kernel runs
only on the card, so this file keeps a small numpy model of its
arithmetic: the word step, the carry between words and between
segments, the two code planes, the final-row expansion and the packed
layout. The model is held bit-equal to the plain row loop
(ops/editdp.py::forward_plain), to the JAX package's `last_rows` and
`align_with_codes`, and, for the layout, to `cuda_editdp.pack_codes`.
`cuda_editdp.symbol_codes`, the wrapper's remap of the int16 symbols
to the kernel's table, is held here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repeatresolver_tpu.ops import editdp as jed
from repeatresolver_tpu_torch.ops import cuda_editdp as ce
from repeatresolver_tpu_torch.ops import editdp as ped

U32 = np.uint32
ONE = U32(1)


def word_step(pv, mv, eq, hin):
    """One word step of kernel C over a batch (numpy uint32 arrays):
    the vertical deltas pv / mv of row x-1 (bit i: M[x-1][y0+i] -
    M[x-1][y0+i-1] is +1 / -1), the row's match bits eq and the carry
    hin in {-1, 0, +1} (M[x][y0-1] - M[x-1][y0-1]). Returns the deltas of
    row x, the carry out of the word's last column, and the code planes:
    code = c_up ? 2 : c_left ? 1 : eq ? 3 : 0 with c_left = mh_in & ~eq
    and c_up = mv & ~eq & ~c_left, so lo = mh_in | eq, hi = (mv & ~mh_in)
    | eq."""
    neg = (hin < 0).astype(U32)
    pos = (hin > 0).astype(U32)
    xv = eq | mv
    eqh = eq | neg
    xh = (((eqh & pv) + pv) ^ pv) | eqh
    ph = mv | ~(xh | pv)
    mh = pv & xh
    hout = (ph >> U32(31)).astype(np.int64) - (mh >> U32(31)).astype(np.int64)
    ph = (ph << ONE) | pos
    mh = (mh << ONE) | neg
    lo = mh | eq
    hi = (mv & ~mh) | eq
    return mh | ~(xv | ph), ph & xv, hout, lo, hi


def model_fill(q, qlens, t, seg_words=None):
    """The model of kernel C: q int16 [B, Lq], qlens [B], t int16
    [B, Lt]. Words of 32 columns, seg_words to a segment (the kernel's
    layout by default), segment after segment with the carry of the last
    word handed on per row. Returns (final rows int64 [B, Lt], the code
    planes lo, hi uint32 [Lq, B, words]) for every row x < Lq."""
    b, lq = q.shape
    lt = t.shape[1]
    words = -(-lt // 32)
    if seg_words is None:
        threads, nseg, _ = ce.layout(lq, lt)
        seg_words = threads
    qc, tc, nsym = (np.asarray(v) if isinstance(v, torch.Tensor) else v
                    for v in ce.symbol_codes(torch.from_numpy(q),
                                             torch.from_numpy(t)))
    tcp = np.full((b, words * 32), nsym, np.int64)   # past Lt: no symbol
    tcp[:, :lt] = tc
    bits = (ONE << np.arange(32, dtype=U32))
    peq = np.stack([((tcp.reshape(b, words, 32) == c) * bits).sum(
        axis=-1).astype(U32) for c in range(nsym)], axis=-1)
    lo = np.zeros((lq, b, words), U32)
    hi = np.zeros((lq, b, words), U32)
    fr = np.zeros((b, lt), np.int64)
    carry = np.ones((b, lq), np.int64)      # M[x][-1] - M[x-1][-1] = +1
    rows = np.arange(b)
    for w0 in range(0, words, seg_words):
        ks = range(w0, min(w0 + seg_words, words))
        pv = {k: np.zeros(b, U32) for k in ks}
        mv = {k: np.zeros(b, U32) for k in ks}
        last = {k: np.zeros(b, np.int64) for k in ks}   # M[x][y0 + 31]
        for x in range(lq):
            h = carry[:, x]
            for k in ks:
                eq = peq[rows, k, qc[:, x]]
                pv[k], mv[k], h, lo[x, :, k], hi[x, :, k] = word_step(
                    pv[k], mv[k], eq, h)
                last[k] = last[k] + h
                for r in np.flatnonzero(qlens == x + 1):
                    # expand the row down from the word's last column
                    for i in range(32):
                        y = 32 * k + i
                        if y < lt:
                            above = U32((0xFFFFFFFE << i) & 0xFFFFFFFF)
                            fr[r, y] = last[k][r] - (
                                int(pv[k][r] & above).bit_count()
                                - int(mv[k][r] & above).bit_count())
            carry[:, x] = h                 # into the next segment
    return fr, lo, hi


def planes_to_int8(lo, hi, lt):
    """int8 codes [Lq, B, Lt] from the two planes [Lq, B, words]."""
    sh = np.arange(32, dtype=U32)
    c = (((lo[..., None] >> sh) & ONE) | (((hi[..., None] >> sh) & ONE)
                                         << ONE)).astype(np.int8)
    return c.reshape(lo.shape[0], lo.shape[1], -1)[:, :, :lt]


def planes_to_packed(lo, hi, qlens, lt):
    """The packed layout [B, nseg, steps, T, 2] from the planes, rows
    x < qlen written, the bits of columns past Lt and everything else
    0."""
    lq, b, words = lo.shape
    threads, nseg, steps = ce.layout(lq, lt)
    out = np.zeros((b, nseg, steps, threads, 2), U32)
    for j in range(words):
        seg, k = divmod(j, threads)
        cols = min(lt - 32 * j, 32)
        mask = U32((1 << cols) - 1)
        for r in range(b):
            n = int(qlens[r])
            out[r, seg, k:k + n, k, 0] = lo[:n, r, j] & mask
            out[r, seg, k:k + n, k, 1] = hi[:n, r, j] & mask
    return out


def batch(seed, b, lq, lt, *, pad_q=100, pad_t=None, pad_from=None,
          shared=False):
    """Queries (mutated slices of the target, pad `pad_q`), qlens with
    0, 1 and Lq among them, and targets [B, Lt] (one row repeated when
    shared) whose columns from pad_from on are `pad_t` in every other
    row."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, lt).astype(np.int16)
    t[lt // 5:lt // 5 + min(lt // 6, 12)] = 1       # homopolymer run
    lens = rng.integers(0, lq + 1, b).astype(np.int32)
    lens[:3] = [lq, 0, 1][:b]
    q = np.full((b, lq), pad_q, np.int16)
    for r in range(b):
        n = int(lens[r])
        src = np.resize(np.roll(t, -int(rng.integers(0, lt))), n)
        mut = rng.random(n) < 0.15
        src[mut] = rng.integers(0, 4, int(mut.sum()))
        q[r, :n] = src
    tg = np.repeat(t[None], b, axis=0)
    if not shared:
        tg = np.stack([np.roll(t, 5 * r) for r in range(b)])
        if pad_from is not None:
            tg[::2, pad_from:] = pad_t
    return q, lens, tg


CASES = {
    # name: (seed, B, Lq, Lt, batch kwargs, words a segment)
    "lt_not_multiple": (0, 6, 40, 90, dict(shared=True), None),
    "lt_below_32": (1, 5, 17, 13, dict(shared=True), None),
    "lt_1": (2, 4, 9, 1, dict(shared=True), None),
    "lq_above_lt": (3, 5, 70, 45, dict(shared=True), None),
    "cut_pads_200": (4, 6, 12, 150, dict(pad_t=200, pad_from=77), None),
    "pad_equals_pad": (5, 6, 30, 100, dict(pad_t=100, pad_from=60), None),
    "second_segment": (6, 5, 25, 200, dict(shared=True), 3),
    "three_segments": (7, 4, 20, 230, dict(pad_t=200, pad_from=120), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_word_recurrence_matches_plain_and_jax(name):
    """Final rows and the codes of every row (past qlen included, as
    align_with_codes gives them) of the word model equal forward_plain's
    and the JAX package's."""
    seed, b, lq, lt, kw, seg_words = CASES[name]
    q, lens, tg = batch(seed, b, lq, lt, **kw)
    assert {0, lq} <= set(lens.tolist())
    fr_m, lo, hi = model_fill(q, lens, tg, seg_words)
    codes_p = torch.empty((lq, b, lt), dtype=torch.int8)
    fr_p = ped.forward_plain(torch.from_numpy(q), torch.from_numpy(lens),
                             torch.from_numpy(tg), codes_p)
    np.testing.assert_array_equal(fr_m, fr_p.numpy())
    np.testing.assert_array_equal(planes_to_int8(lo, hi, lt),
                                  codes_p.numpy())
    np.testing.assert_array_equal(
        fr_m, np.asarray(jed.last_rows(jnp.asarray(q), jnp.asarray(lens),
                                       jnp.asarray(tg))))
    if kw.get("shared"):
        codes_j, fr_j = jed.align_with_codes(q, lens, tg[0])
        np.testing.assert_array_equal(planes_to_int8(lo, hi, lt),
                                      np.asarray(codes_j).transpose(1, 0, 2))
        np.testing.assert_array_equal(fr_m, np.asarray(fr_j))


@pytest.mark.parametrize("lq,lt", [(30, 90), (5, 33000)])
def test_word_planes_in_the_packed_layout(lq, lt):
    """The model's planes, stored where kernel C stores them (rows below
    qlen), equal cuda_editdp.pack_codes of the plain codes on those rows,
    in one segment and in two (33,000 columns, the real layout)."""
    q, lens, tg = batch(8, 4, lq, lt, shared=True)
    _, lo, hi = model_fill(q, lens, tg)
    codes_p = torch.empty((lq, 4, lt), dtype=torch.int8)
    ped.forward_plain(torch.from_numpy(q), torch.from_numpy(lens),
                      torch.from_numpy(tg), codes_p)
    want = ce.pack_codes(codes_p).numpy().view(U32)
    got = planes_to_packed(lo, hi, lens, lt)
    x = ce.packed_rows(lq, lt).numpy()
    assert ce.layout(lq, lt)[1] == (2 if lt > 32768 else 1)
    for r, n in enumerate(lens):
        rows = (x >= 0) & (x < n)
        np.testing.assert_array_equal(got[r][:, rows], want[r][:, rows])


def test_symbol_codes_preserve_equality():
    """The remap of int16 symbols to kernel C's table: a query code
    equals a target code exactly where the symbols are equal (pads 100
    and 200 and negative values included), target symbols are dense from
    0 and every query symbol that no target holds gets the last code;
    an eighth distinct target symbol raises."""
    rng = np.random.default_rng(9)
    vals = np.array([0, 1, 2, 3, 100, 200, -7, 32767, 5], np.int16)
    q = rng.choice(vals, (5, 40)).astype(np.int16)
    t = rng.choice(vals[:7], (1, 60)).astype(np.int16)
    qc, tc, n = ce.symbol_codes(torch.from_numpy(q), torch.from_numpy(t))
    assert qc.dtype == tc.dtype == torch.uint8
    assert qc.shape == q.shape and tc.shape == t.shape
    assert n == len(set(t.ravel())) + 1
    qv, tv = q.ravel(), t.ravel()
    qn, tn = qc.numpy().ravel(), tc.numpy().ravel()
    np.testing.assert_array_equal(qv[:, None] == tv[None, :],
                                  qn[:, None] == tn[None, :])
    np.testing.assert_array_equal(tv[:, None] == tv[None, :],
                                  tn[:, None] == tn[None, :])
    assert set(tn.tolist()) == set(range(n - 1))
    assert (qn[~np.isin(qv, tv)] == n - 1).all()
    # a stride-0 expand of one query, as cut passes it
    qe = torch.from_numpy(q[:1]).expand(5, -1)
    np.testing.assert_array_equal(ce.symbol_codes(qe, torch.from_numpy(t))[0],
                                  np.repeat(qc.numpy()[:1], 5, axis=0))
    t[0, :8] = np.arange(8) + 10
    with pytest.raises(ValueError, match="distinct target symbols"):
        ce.symbol_codes(torch.from_numpy(q), torch.from_numpy(t))
