"""The plain reference of realign's sweeps, in numpy.

PW_ReAligner's row step (Matrix_Filler and Backtracker,
PW_ReAligner.c:1334-1531): a row is taken out of the column histogram,
its bases are placed again by a banded DP against the histogram of the
other rows, and the columns it inserts are spliced in. The cost of a
base b in column y is Score(y, b), the rows there that hold neither b nor
a coverage gap; skipping a column costs Score(y, '-'); a base put into a
new column after y costs max(Score(y, ' '), Score(y - 1, ' ')). Codes:
0-3 bases, 4 '-', 5 ' '.

The arithmetic is the serial engine's of the JAX package, which the port
also carries (`RealignEngine`): written again here as functions over
arrays, with the band read through one extended row a step. Nothing here
imports the program.

  * `serial_rows`: the reference's serial (Gauss-Seidel) sweep over a
    range of rows, every row against the current histogram, its inserts
    spliced at once and empty columns dropped before each row (W_Con);
    from a sweep's input, or from a state inside the sweep.
  * `first_block`, `block_at` and `jacobi_row`: the rows of a Jacobi
    block (the sweep's first, from its input, or any block, from the
    state the sweep reached at its start), each against the block's
    starting histogram less its own row, inserts returned, not spliced.

`ties` names the backtrack's order among equal-cost moves: "ref" is
the reference's (gap, then the trailing space, then the diagonal, then
the insert); "diag" tries the diagonal first, a control that breaks the
tie guarantee.
"""
from __future__ import annotations

import numpy as np

HUGE = np.int64(1) << 40


def symbol_counts(msa: np.ndarray) -> np.ndarray:
    """int64 [cols, 6]: each column's count of each symbol."""
    counts = np.zeros((msa.shape[1], 6), np.int64)
    step = max(1, (1 << 24) // max(msa.shape[1], 1))
    for k0 in range(0, msa.shape[0], step):
        m = msa[k0:k0 + step]
        for s in range(6):
            counts[:, s] += (m == s).sum(axis=0)
    return counts


def ent_al_gapper(msa: np.ndarray) -> np.ndarray:
    """EntAlGapper (PW_ReAligner.c:459-645): '-' before a row's first
    base and after its last becomes ' ', then columns without a base go."""
    msa = np.array(msa, dtype=np.int8, copy=True)
    c = msa.shape[1]
    base = msa < 4
    anyb = base.any(axis=1)
    first = np.where(anyb, base.argmax(axis=1), c)
    last = np.where(anyb, c - 1 - base[:, ::-1].argmax(axis=1), -1)
    cols = np.arange(c)[None, :]
    out = (cols < first[:, None]) | (cols > last[:, None])
    msa[out & (msa == 4)] = 5
    return drop_empty(msa)


def drop_empty(msa: np.ndarray) -> np.ndarray:
    keep = (msa < 4).any(axis=0)
    return msa if keep.all() else np.ascontiguousarray(msa[:, keep])


def score(msa: np.ndarray) -> int:
    """OverallScore (PW_ReAligner.c:933-963) as one integer: the sum
    over columns of count(b) * (nonspace - count(b)) over b in 0-4."""
    counts = symbol_counts(msa)
    ns = counts[:, 0:5].sum(axis=1)
    return int((counts[:, 0:5] * (ns[:, None] - counts[:, 0:5])).sum())


def row_dp(counts: np.ndarray, row_old: np.ndarray, bw: int,
           ties: str = "ref"):
    """One row's banded DP and backtrack. counts: int64 [c, 6], the
    histogram without this row. Returns (new_row int8 [c], inserts
    [(y, base)] in discovery order: each base goes into a new column
    after column y)."""
    c = len(row_old)
    basepos = np.flatnonzero(row_old < 4)
    seq = row_old[basepos].astype(np.int64)
    n = len(basepos)
    new = np.full(c, 5, np.int8)
    if n == 0:
        return new, []
    ns = counts[:, 0:5].sum(axis=1)
    gapcost = ns - counts[:, 4]
    subcost = ns[:, None] - counts[:, 0:4]
    inscost = np.empty(c, np.int64)
    inscost[0] = ns[0]
    inscost[1:] = np.maximum(ns[1:], ns[:-1])
    gp = np.concatenate([[0], np.cumsum(gapcost)])
    bh = bw // 2
    anf = np.maximum(0, basepos - bh)
    end = np.minimum(c, anf + bw)
    m = np.full((n, bw), HUGE, np.int64)
    okins = np.zeros(c, bool)
    okins[1:c - 1] = True
    for x in range(n):
        a, e = int(anf[x]), int(end[x])
        w = e - a
        b = int(seq[x])
        if x == 0:
            diag = subcost[a:e, b]
            ups = inscost[a:e]
        else:
            # the previous row over columns [a - 1, e): in band, the
            # jump above its band, HUGE below it
            pa, pe = int(anf[x - 1]), int(end[x - 1])
            prev = np.empty(w + 1, np.int64)
            lo = a - 1
            k_in0 = max(lo, pa) - lo
            k_in1 = min(e, pe) - lo
            prev[:k_in0] = HUGE
            prev[k_in0:k_in1] = m[x - 1, max(lo, pa) - pa:min(e, pe) - pa]
            if k_in1 < w + 1:
                top = pa + bw - 1
                ys = np.arange(lo + k_in1, e)
                prev[k_in1:] = m[x - 1, bw - 1] + (gp[ys + 1] - gp[top + 1])
            diag = prev[:w] + subcost[a:e, b]
            ups = prev[1:] + inscost[a:e]
        av = np.where(okins[a:e], np.minimum(diag, ups), diag)
        g = gp[a + 1:e + 1]
        m[x, :w] = np.minimum.accumulate(av - g) + g
    return _backtrack(m, anf, basepos, seq, gapcost, subcost, inscost, gp,
                      bw, c, ties)


def _backtrack(m, anf, basepos, seq, gapcost, subcost, inscost, gp, bw, c,
               ties):
    last = len(seq) - 1
    anf_l = anf.tolist()
    huge = int(HUGE)

    def read(x, y):
        if x == -1:
            return 0
        if y == -1:
            return huge
        a = anf_l[x]
        d = y - a
        if d < 0:
            return huge
        if d > bw - 1:
            if x == last:
                return m.item(x, bw - 1)
            return m.item(x, bw - 1) + int(gp[y + 1] - gp[a + bw])
        return m.item(x, d)

    new = np.full(c, 5, np.int8)
    # entry scan (Backtracker :1352-1360): the least M over the last
    # row's columns above its bound, the largest column on ties
    x = last
    bound = max(-1, int(basepos[x]) - bw // 2)
    a = anf_l[x]
    ys = np.arange(bound + 1, c)
    vals = np.full(len(ys), HUGE, np.int64)
    d = ys - a
    inb = (d >= 0) & (d <= bw - 1)
    vals[inb] = m[x, d[inb]]
    above = d > bw - 1
    vals[above] = m[x, bw - 1]
    best = read(x, c - 1)
    wayin = c - 1
    if len(vals):
        vmin = int(vals.min())
        if vmin < best:
            wayin = int(ys[np.flatnonzero(vals == vmin)[-1]])
    y = wayin
    inserts = []
    gapc = gapcost.tolist()
    insc = inscost.tolist()
    seq_l = seq.tolist()
    diag_first = ties == "diag"
    while x > -1 and y > -1:
        mxy = read(x, y)
        sx = seq_l[x]
        if diag_first and mxy == read(x - 1, y - 1) + int(subcost[y, sx]):
            new[y] = sx
            x -= 1
            y -= 1
            continue
        left = read(x, y - 1)
        if mxy == left + gapc[y]:
            new[y] = 5 if x == last else 4
            y -= 1
        elif mxy == left and x == last:
            y -= 1
        elif mxy == read(x - 1, y - 1) + int(subcost[y, sx]):
            new[y] = sx
            x -= 1
            y -= 1
        elif y > 0 and mxy == read(x - 1, y) + insc[y]:
            inserts.append((y, sx))
            x -= 1
        else:
            raise AssertionError(f"backtrack dead end at x={x} y={y}")
    return new, inserts


def splice(msa: np.ndarray, inserts) -> np.ndarray:
    """Column_Adder (PW_ReAligner.c:1245-1332) for a batch: inserts
    [(gap, row, base)] in splice order; each new column follows column
    gap, holds its row's base, and for every other row ' ' where either
    pre-splice neighbour is ' ' (or gap is the last column), else '-'."""
    if not inserts:
        return msa
    r, c = msa.shape
    gaps = np.array([g for g, _, _ in inserts], np.int64)
    cols = np.where((msa[:, gaps] == 5)
                    | (msa[:, np.minimum(gaps + 1, c - 1)] == 5)
                    | (gaps == c - 1)[None, :], 5, 4).astype(np.int8)
    cols[[k for _, k, _ in inserts], np.arange(len(inserts))] = \
        [b for _, _, b in inserts]
    return np.insert(msa, gaps + 1, cols, axis=1)


def serial_rows(msa: np.ndarray, bw: int, nrows: int,
                ties: str = "ref", start: int = 0) -> np.ndarray:
    """A serial sweep's rows start .. start + nrows - 1: the MSA after
    them. start 0: from the sweep's input (before realign's
    EntAlGapper); start > 0: from the sweep's state after its first
    `start` rows (its columns as the sweep left them)."""
    if start == 0:
        msa = ent_al_gapper(msa)
    else:
        msa = np.array(msa, dtype=np.int8, copy=True)
    counts = symbol_counts(msa)
    for k in range(start, min(start + nrows, msa.shape[0])):
        keep = counts[:, 0:4].sum(axis=1) > 0             # W_Con
        if not keep.all():
            msa = np.ascontiguousarray(msa[:, keep])
            counts = counts[keep]
        c = msa.shape[1]
        old = msa[k].copy()
        np.subtract.at(counts, (np.arange(c), old.astype(np.int64)), 1)
        new, ins = row_dp(counts, old, bw, ties)
        np.add.at(counts, (np.arange(c), new.astype(np.int64)), 1)
        msa[k] = new
        if ins:
            # discovery order is non-increasing in y: each splice after
            # y shifts no later (smaller) gap
            for y, base in ins:
                msa = splice(msa, [(y, k, base)])
            counts = symbol_counts(msa)
    return msa


def first_block(msa: np.ndarray, block_rows: int, pick):
    """A Jacobi sweep's first block from the sweep's input (before
    realign's EntAlGapper): `block_at(EntAlGapper(msa), block_rows, 0,
    pick)`."""
    return block_at(ent_al_gapper(msa), block_rows, 0, pick)


def block_at(msa: np.ndarray, block_rows: int, block: int, pick,
             lengths=None):
    """Block `block` of a Jacobi sweep from the state the sweep reached
    at its start: the rows by length, longest first, ties in row order,
    `block_rows` a block. lengths: the rows' base counts (by default
    msa's; inside a sweep the rows already realigned hold their inserted
    bases in no column until the sweep splices them, so the caller gives
    the reads'). pick: indices into the block (every row of a last block
    shorter than them all). Returns (the state, its histogram, the
    picked row ids)."""
    counts = symbol_counts(msa)
    if lengths is None:
        lengths = (msa < 4).sum(axis=1)
    order = np.argsort(-np.asarray(lengths), kind="stable")
    rows = order[block * block_rows:(block + 1) * block_rows].tolist()
    return msa, counts, [rows[i] for i in pick if i < len(rows)] or rows


def jacobi_row(counts: np.ndarray, row: np.ndarray, bw: int,
               ties: str = "ref"):
    """A row of a Jacobi block: its DP against the block's histogram
    less its own row. Returns row_dp's (new row, inserts)."""
    own = np.zeros_like(counts)
    np.add.at(own, (np.arange(len(row)), row.astype(np.int64)), 1)
    return row_dp(counts - own, row, bw, ties)
