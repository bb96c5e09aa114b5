"""The initial MSA of a cell, laid out from the reads' true alignments.

InitialAligner's layout (Building_MSA, InitialAligner.c:553-663): every
template column has a base column, and before it as many gap columns as
the longest run of inserted bases that any row puts there; a row holds
its bases at their template columns and its inserted runs left-aligned
in the gap columns, '-' elsewhere inside its span and ' ' (a coverage
gap) outside it. A run between placed bases at template columns p < q
goes before column p + 1, a leading run before the first placed base's
column, a trailing run after the last placed base's column.

Departures from ReadCutter plus InitialAligner (listed under `assumed`
in each configuration): the alignment is the read's true path through
the simulator, not an edit-distance DP; a row is the part of a read that
came from the copy's repeat (from its first to its last repeat base),
not a piece cut by template matching; the reference's leading-run spill
(a ragged row) is not reproduced, and no piece is dropped for its error
rate.

The seed draws the template, the copies, the flanks and the reads'
errors; the reads' starts and lengths come from a stream of their own,
`plan_seed`, the same for every seed; and the seed shuffles the rows.
So every seed gives the same set of read sizes and positions, in
another order, and the seed does not change how much work a cell is.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import simulator as sim

GAP, SPACE = 4, 5


@dataclass
class CellInput:
    template: np.ndarray          # uint8 [tlen]
    msa: np.ndarray               # int8 [rows, width], codes 0-5
    rows: list                    # per row: uint8 bases (the read's part)
    copy_of_row: np.ndarray       # int64 [rows]


def repeat_parts(reads: list[sim.Read]):
    """Each read's repeat part: (bases, template columns, copy), from
    its first to its last repeat base; reads with no base placed on a
    template column make no row."""
    out = []
    for r in reads:
        idx = np.flatnonzero(r.repeat)
        if idx.size == 0:
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        cols = r.cols[lo:hi]
        if not (cols >= 0).any():
            continue
        out.append((r.seq[lo:hi], cols, r.copy))
    return out


def _runs(cols: np.ndarray):
    """For one row: (slot, offset) of each inserted base (cols == -1):
    the slot a run goes to and the base's place in its run."""
    n = len(cols)
    placed = cols >= 0
    i = np.arange(n)
    last_p = np.maximum.accumulate(np.where(placed, i, -1))
    first_p = int(np.flatnonzero(placed)[0])
    slot = np.where(last_p >= 0, cols[np.maximum(last_p, 0)] + 1,
                    cols[first_p])
    offset = np.where(last_p >= 0, i - last_p - 1, i)
    return slot[~placed], offset[~placed]


def layout(template: np.ndarray, parts) -> CellInput:
    tlen = len(template)
    gapcount = np.zeros(tlen + 1, np.int64)
    runs = []
    for seq, cols, _ in parts:
        slot, off = _runs(cols)
        runs.append((slot, off))
        if slot.size:
            np.maximum.at(gapcount, slot, off + 1)
    gap_start = np.concatenate([[0], np.cumsum(gapcount[:-1] + 1)])
    base_col = gap_start[:tlen] + gapcount[:tlen]
    width = int(gap_start[tlen] + gapcount[tlen])
    r = len(parts)
    msa = np.full((r, width), GAP, np.int8)
    for k, ((seq, cols, _), (slot, off)) in enumerate(zip(parts, runs)):
        pos = np.empty(len(seq), np.int64)
        placed = cols >= 0
        pos[placed] = base_col[cols[placed]]
        pos[~placed] = gap_start[slot] + off
        row = msa[k]
        row[:pos[0]] = SPACE
        row[pos[-1] + 1:] = SPACE
        row[pos] = seq
    return CellInput(template=template, msa=msa,
                     rows=[p[0] for p in parts],
                     copy_of_row=np.array([p[2] for p in parts], np.int64))


def make_cell_input(cfg: dict, copies: int, seed: int,
                    plan_seed: int = 1) -> CellInput:
    """The cell's inputs from its configuration and `--seed`."""
    template, _copies, reads = sim.simulate(
        cfg["structure"], cfg["coverage"], copies, cfg["difference"],
        cfg["repeatlength"], cfg["flank"], seed, plan_seed)
    parts = repeat_parts(reads)
    order = np.random.default_rng([seed, 2]).permutation(len(parts))
    return layout(template, [parts[i] for i in order])
