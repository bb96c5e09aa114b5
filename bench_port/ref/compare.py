"""The comparisons that decide a realign cell's `correct`.

A sweep's rows cannot be checked one by one from its output alone: each
row was placed against the histogram of the rows before it. So the
reference follows the sweep from the state the program started it from
(the cell's generated MSA, or the program's previous sweep): it places
the sweep's first rows itself, and compares them with the program's.

What is compared is geometry-free. Columns that later rows insert, and
columns that go empty and are dropped, do not move a row's bases
relative to the other checked rows' bases; so for a set of rows the
comparison takes the columns where any of them holds a base, and gives
each base the index of its column among those. `moved_bases` counts
the bases whose index differs between the program's rows and the
reference's; an exact comparison, limit 0.

The reference runs in worker processes (numpy, nothing of the program),
one row of a Jacobi block or one serial range a task. A sweep's first
block and first rows are placed from the sweep's input; a later block or
row range from the program's own state at its start, which the cell
captures (`bench_port.capture`) in a run of the same sweeps after the
window, whose outputs must equal the window's.
"""
from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np

from . import realign as rr


def projection(rows: np.ndarray) -> list[np.ndarray]:
    """Per row, the index of each base's column among the columns where
    any of `rows` holds a base."""
    isb = rows < 4
    sub = isb[:, isb.any(axis=0)]
    return [np.flatnonzero(r) for r in sub]


def moved_bases(prog_rows: np.ndarray, ref_rows: np.ndarray) -> int:
    """Bases whose column index differs between the program's rows and
    the reference's (a row of another length counts all its bases)."""
    n = 0
    for a, b in zip(projection(prog_rows), projection(ref_rows)):
        n += int((a != b).sum()) if len(a) == len(b) else max(len(a),
                                                              len(b))
    return n


def rows_altered(out: np.ndarray, truth: list) -> int:
    """Rows whose bases, in order, are not the read's."""
    return sum(1 for k, t in enumerate(truth)
               if not np.array_equal(out[k][out[k] < 4].astype(np.uint8), t))


def layout_faults(out: np.ndarray) -> int:
    """Columns without a base, plus '-' cells outside their row's span
    (realign's EntAlGapper leaves neither)."""
    isb = out < 4
    n = int((~isb.any(axis=0)).sum())
    c = out.shape[1]
    first = isb.argmax(axis=1)
    last = c - 1 - isb[:, ::-1].argmax(axis=1)
    cols = np.arange(c)[None, :]
    outside = (cols < first[:, None]) | (cols > last[:, None])
    return n + int((outside & (out == 4)).sum())


def score_gap(out: np.ndarray, program_total: int) -> int:
    """|the program's score for its output - the reference's recount|."""
    return abs(rr.score(out) - int(program_total))


def _jacobi_task(args):
    counts, row, bw, ties = args
    return rr.jacobi_row(counts, row, bw, ties)


def _serial_task(args):
    msa, bw, start, nrows, ties = args
    return rr.serial_rows(msa, bw, nrows, ties, start)[start:start + nrows]


def _subset_rows(news, rows, inserts) -> np.ndarray:
    """The checked rows of a Jacobi block as the sweep leaves them: their
    new rows with their own inserted columns spliced in sweep order
    (gap, row, reverse discovery)."""
    sub = np.stack(news)
    pos = {k: i for i, k in enumerate(rows)}
    ins = sorted(inserts, key=lambda t: (t[0], t[1], -t[2]))
    if not ins:
        return sub
    cols = np.full((sub.shape[0], len(ins)), 4, np.int8)
    for j, (_, k, _, b) in enumerate(ins):
        cols[pos[k], j] = b
    return np.insert(sub, [g + 1 for g, _, _, _ in ins], cols, axis=1)


class RealignChecks:
    """Sweep checks in worker processes, started together, gathered by
    `results`. With control, the control (the reference with the
    diagonal tried first) is placed too, and compared in the program's
    place."""

    def __init__(self, control: bool = False, workers: int | None = None):
        n = workers or max(1, min(8, (os.cpu_count() or 2) - 1))
        self.pool = mp.get_context("spawn").Pool(n)
        self.ties = ("ref", "diag") if control else ("ref",)
        self.pending = []

    def jacobi(self, name, msa_in, out, bw, block_rows, pick):
        """The first Jacobi block of the sweep that took msa_in to out:
        the picked rows placed by the reference against the block's
        histogram, compared with the program's rows in out."""
        self._jacobi(name, rr.first_block(msa_in, block_rows, pick), out,
                     bw)

    def jacobi_at(self, name, state, out, bw, block_rows, block, pick,
                  lengths):
        """Block `block` of the sweep that ended in out, from `state`, the
        program's own state at that block's start; lengths: the rows'
        base counts, which order the blocks."""
        self._jacobi(name, rr.block_at(state, block_rows, block, pick,
                                       lengths), out, bw)

    def _jacobi(self, name, prepared, out, bw):
        msa_g, counts, rows = prepared
        futs = {t: [self.pool.apply_async(
            _jacobi_task, ((counts, msa_g[k], bw, t),)) for k in rows]
            for t in self.ties}
        self.pending.append(("jacobi", name, rows, out, futs))

    def serial(self, name, msa, out, bw, nrows, start=0):
        """Rows start .. start + nrows - 1 of the serial sweep that ended
        in out, placed by the reference one after another: from msa, the
        sweep's input (start 0) or the program's own state after the
        sweep's first `start` rows."""
        futs = {t: self.pool.apply_async(_serial_task,
                                         ((msa, bw, start, nrows, t),))
                for t in self.ties}
        self.pending.append(("serial", name, range(start, start + nrows),
                             out, futs))

    def results(self) -> list[tuple[str, int, int | None]]:
        """(name, the program's moved bases, the control's or None)."""
        out = []
        try:
            for kind, name, rows, prog, futs in self.pending:
                got = {}
                for t, f in futs.items():
                    if kind == "jacobi":
                        res = [x.get() for x in f]
                        ins = [(y, k, o, b) for k, (_, i_k) in
                               zip(rows, res)
                               for o, (y, b) in enumerate(i_k)]
                        got[t] = _subset_rows([r for r, _ in res], rows, ins)
                    else:
                        got[t] = f.get()
                mine = prog[list(rows)]
                ctl = (moved_bases(got["diag"], got["ref"])
                       if "diag" in got else None)
                out.append((name, moved_bases(mine, got["ref"]), ctl))
        finally:
            self.pool.terminate()
            self.pool.join()
        return out


def as_checks(results, control: bool) -> list[tuple[str, int, int]]:
    """Checks of limit 0 from `RealignChecks.results`: the program's
    numbers, or with control the control's under the same names and the
    program's as `program.<name>`."""
    if not control:
        return [(name, v, 0) for name, v, _ in results]
    return ([(name, c, 0) for name, _, c in results]
            + [("program." + name, v, 0) for name, v, _ in results])
