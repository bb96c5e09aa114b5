"""Sum-of-pairs MSA refinement (the reference's PW_ReAligner), host side.

Counterpart of repeatresolver_tpu/models/realigner.py:

  * `RealignEngine` and `realign`, the reference-exact serial engine in
    numpy (Gauss-Seidel row sweeps): the semantic oracle of every other
    engine at block 1.
  * `BatchedRealigner`, block-Jacobi over length-sorted blocks with the
    inserts of a sweep spliced at its end; block_rows=1 is the
    reference's serial Gauss-Seidel sweep. Its block DP runs on one of
    three routes: kernel="native", the exact band through the native
    C++ block DP (utils/native.realign_block; the anneal's tail and the
    resident engine's exact blocks); kernel="torch", the plain torch
    versions (ops/banded_realign, ops/staircase_realign) on `device`;
    kernel="cuda", the staircase fill and the walk through their
    wrappers (kernels A and B on a CUDA device). With a mesh
    (parallel/sharded.Mesh) each block's rows are sharded over the
    ranks of a process group.
  * `realign_batched`, the main loop: best tracking, the anneal,
    checkpoints and resume.

The staircase band equals the exact band for any covering slack, and at
a fixed block size the Jacobi trajectory does not depend on the kernel,
so the engines are interchangeable mid-run (the anneal hands the
resident engine's MSA to the host native one).

The dense-array bookkeeping and the serial engine are copied from the
JAX package's module, same arithmetic.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import RealignerConfig
from ..device import resolve_device
from ..ops import banded_realign as br
from ..ops import cuda_backtrack as cb
from ..ops import cuda_realign as cr
from ..ops import staircase_realign as sr
from ..utils import checkpoint as ckpt
from ..utils import io as rio
from ..utils import native as nat
from ..utils.hostmem import tune_allocator

__all__ = ["BatchedRealigner", "RealignEngine", "realign",
           "realign_batched", "overall_score_pair", "row_score",
           "symbol_counts", "validate_counts"]

HUGE = np.int64(1) << 40

# pending inserts before a mid-sweep flush: a memory bound, but a sweep
# that crosses it flushes mid-sweep, which changes the block>1 Jacobi
# trajectory (same value as the JAX package, so trajectories match)
FLUSH_CAP = 16384


# ---- copied from repeatresolver_tpu/models/realigner.py: the host
# bookkeeping (histogram, score pair, EntAlGapper, column splices) and
# the serial engine

def symbol_counts(msa: np.ndarray) -> np.ndarray:
    """int64[cols, 6] histogram of symbols per column.

    Chunked over rows: full-MSA boolean temporaries are multi-GB at
    paper scale; small reused temporaries avoid faulting them in
    (utils/hostmem.py)."""
    r, c = msa.shape
    counts = np.zeros((c, 6), np.int64)
    step = max(1, (1 << 24) // max(c, 1))
    for k0 in range(0, r, step):
        m = msa[k0:k0 + step]
        for s in range(6):
            counts[:, s] += (m == s).sum(axis=0)
    return counts


def overall_score_pair(counts: np.ndarray) -> tuple[int, int]:
    """The (scoreMille, scoreUno) pair of OverallScorePrint
    (PW_ReAligner.c:933-963), including its '>1000000' carry quirk.

    Row scores are accumulated per row: sum over nonspace cells of
    Score(col, sym). Equivalently per column: sum_b counts[b] *
    (nonspace - counts[b]) for b in 0..4 — but the carry loop runs per
    ROW, so we reproduce the row accumulation.
    """
    ns = counts[:, 0:5].sum(axis=1)
    # per-column total over all rows
    col_total = (counts[:, 0:5] * (ns[:, None] - counts[:, 0:5])).sum()
    return _carry_pair(int(col_total))


def _carry_pair(total: int) -> tuple[int, int]:
    return total // 1000000, total % 1000000


def row_score(msa: np.ndarray, counts: np.ndarray, k: int) -> int:
    row = msa[k]
    ns = counts[:, 0:5].sum(axis=1)
    m = row < 5
    cols = np.nonzero(m)[0]
    return int((ns[cols] - counts[cols, row[cols]]).sum())


@dataclass
class RealignEngine:
    """Reference-exact serial realigner over dense arrays."""
    msa: np.ndarray                  # int8 [R, C], mutated in place-ish
    bandwidth: int = 1000
    counts: np.ndarray = field(init=False)

    def __post_init__(self):
        tune_allocator()   # column splices need warm-page reuse
        self.msa = np.ascontiguousarray(self.msa, dtype=np.int8)
        self.counts = symbol_counts(self.msa)

    def ent_al_gapper(self) -> int:
        """EntAlGapper: leading/trailing '-' -> ' ' per row, then drop
        zero-base columns. Returns number of converted cells.

        Chunked over rows: the boolean temporaries are multi-GB at
        paper scale; small reused temporaries avoid faulting them in
        (utils/hostmem.py)."""
        msa = self.msa
        r, c = msa.shape
        cols = np.arange(c)[None, :]
        convcnt = np.zeros(c, np.int64)
        total = 0
        step = max(1, (1 << 24) // max(c, 1))
        for k0 in range(0, r, step):
            m = msa[k0:k0 + step]
            base = m < 4
            any_base = base.any(axis=1)
            first = np.where(any_base, base.argmax(axis=1), c)
            # argmax on a negative-stride view hits a slow path; flip
            # into a contiguous buffer first
            rev = np.ascontiguousarray(base[:, ::-1])
            last = np.where(any_base, c - 1 - rev.argmax(axis=1), -1)
            outside = (cols < first[:, None]) | (cols > last[:, None])
            conv = outside & (m == 4)
            m[conv] = 5
            convcnt += conv.sum(axis=0)
            total += int(conv.sum())
        self.counts[:, 4] -= convcnt.astype(self.counts.dtype)
        self.counts[:, 5] += convcnt.astype(self.counts.dtype)
        self._drop_empty_columns()
        return total

    def _drop_empty_columns(self) -> None:
        # counts are maintained incrementally at every call site
        # (validate_counts checks the invariant), so emptiness reads
        # from counts in O(C) instead of scanning the MSA
        keep = self.counts[:, 0:4].sum(axis=1) > 0
        if not keep.all():
            idx = np.flatnonzero(keep)
            self.msa = np.ascontiguousarray(
                np.take(self.msa, idx, axis=1))
            self.counts = np.ascontiguousarray(
                np.take(self.counts, idx, axis=0))

    # ------------------------------------------------------ row realign

    def realign_row(self, k: int) -> int:
        """Matrix_Filler(k) + Backtracker(k). Returns the row's new
        banded-DP score (the reference's return value)."""
        self._drop_empty_columns()          # W_Con
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        row_old = msa[k].copy()
        basepos = np.nonzero(row_old < 4)[0]        # TheWay: Way[x]
        seq = row_old[basepos].astype(np.int64)     # Seq_Bases
        length = len(basepos)
        # Columns_Downdater + Base_Downdater (before the length check,
        # like the reference: an empty row is removed and stays blank).
        np.subtract.at(counts, (np.arange(c), row_old.astype(np.int64)),
                       1)
        msa[k] = 5
        if length == 0:
            return 0

        ns = counts[:, 0:5].sum(axis=1)
        gapcost = ns - counts[:, 4]                  # Score(y, 4)
        subcost = ns[:, None] - counts[:, 0:4]       # Score(y, base)
        inscost = np.empty(c, np.int64)              # max(S(y,5),S(y-1,5))
        inscost[0] = ns[0]
        if c > 1:
            inscost[1:] = np.maximum(ns[1:], ns[:-1])
        gp = np.concatenate([[0], np.cumsum(gapcost)])  # gp[y+1]=sum<=y

        bw = self.bandwidth
        bh = bw // 2
        anf = np.maximum(0, basepos - bh)
        end = np.minimum(c, anf + bw)

        m = np.full((length, bw), HUGE, np.int64)

        def read_prev(x: int, ys: np.ndarray) -> np.ndarray:
            """MatrixOut(x, ys) for a previous row x (vectorized),
            x >= 0, may include ys == -1 / off-band."""
            a, e = int(anf[x]), int(end[x])
            top = a + bw - 1
            out = np.full(len(ys), HUGE, np.int64)
            inband = (ys >= a) & (ys < e)
            out[inband] = m[x, ys[inband] - a]
            above = ys > top
            if above.any():
                # jump: M[x][top] + sum of gap costs (top, y]
                yy = ys[above]
                out[above] = m[x, bw - 1] + (gp[yy + 1] - gp[top + 1])
            # ys < a (incl. -1) stay HUGE
            return out

        for x in range(length):
            a, e = int(anf[x]), int(end[x])
            ys = np.arange(a, e)
            b = int(seq[x])
            if x == 0:
                # MatrixOut(-1, ·) = 0 for every y (PW_ReAligner.c:256)
                diag = subcost[ys, b]
                ups = inscost[ys].astype(np.int64)
            else:
                diag = read_prev(x - 1, ys - 1) + subcost[ys, b]
                ups = read_prev(x - 1, ys) + inscost[ys]
            ok_ins = (ys > 0) & (ys < c - 1)
            av = np.where(ok_ins, np.minimum(diag, ups), diag)
            # left relaxation: M[y] = min(A[y], M[y-1] + gapcost[y])
            rel = np.minimum.accumulate(av - gp[ys + 1]) + gp[ys + 1]
            m[x, :len(ys)] = rel
            if len(ys) < bw:
                m[x, len(ys):] = HUGE

        return self._backtrack(k, length, basepos, seq, anf,
                               m, gapcost, subcost, inscost, gp)

    def _read_m(self, x, y, length, anf, m, gp):
        """MatrixOut for the backtracker (scalar)."""
        if x == -1:
            return 0
        if y == -1:
            return int(HUGE)
        a = int(anf[x])
        bw = self.bandwidth
        if y - a < 0:
            return int(HUGE)
        if y - a > bw - 1:
            if x == length - 1:
                return int(m[x, bw - 1])
            return int(m[x, bw - 1] + (gp[y + 1] - gp[a + bw]))
        return int(m[x, y - a])

    def _backtrack(self, k, length, basepos, seq, anf, m,
                   gapcost, subcost, inscost, gp) -> int:
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        bh = self.bandwidth // 2

        def place(y: int, sym: int) -> None:
            counts[y, sym] += 1
            msa[k, y] = sym

        # entry scan (Backtracker :1352-1360)
        x = length - 1
        bound = max(-1, int(basepos[x]) - bh)
        best = self._read_m(x, c - 1, length, anf, m, gp)
        wayin = c - 1
        y = c - 1
        while y > bound:
            v = self._read_m(x, y, length, anf, m, gp)
            if v < best:
                best = v
                wayin = y
            y -= 1
        for y in range(c - 1, wayin, -1):
            place(y, 5)
        y = wayin

        inserts: list[tuple[int, int]] = []  # (logical y, base) pending
        while x > -1 and y > -1:
            mxy = self._read_m(x, y, length, anf, m, gp)
            left = self._read_m(x, y - 1, length, anf, m, gp)
            if mxy == left + int(gapcost[y]):
                place(y, 5 if x == length - 1 else 4)
                y -= 1
            elif mxy == left and x == length - 1:
                place(y, 5)
                y -= 1
            elif mxy == self._read_m(x - 1, y - 1, length, anf, m, gp) \
                    + int(subcost[y, int(seq[x])]):
                place(y, int(seq[x]))
                x -= 1
                y -= 1
            elif y > 0 and mxy == self._read_m(x - 1, y, length, anf,
                                               m, gp) + int(inscost[y]):
                inserts.append((y, int(seq[x])))
                x -= 1
            else:
                raise AssertionError(
                    f"backtrack dead end at x={x} y={y} (row {k})")
        while y > -1:
            place(y, 5)
            y -= 1

        # Apply column insertions. They were discovered right-to-left;
        # all inserts at the same y chain before each other exactly like
        # repeated Column_Adder calls after the same Present_Column.
        # Applying in DISCOVERY order at fixed logical y reproduces the
        # reference: each new column lands directly after y, pushing
        # previously inserted ones right.
        if inserts:
            self._apply_inserts(k, inserts)
        return int(best)

    def _apply_inserts(self, k: int, inserts: list[tuple[int, int]]):
        msa = self.msa
        r = msa.shape[0]
        # Process in discovery order; because inserts were discovered at
        # strictly non-increasing y, inserting at position y+1 never
        # shifts the logical index of a LATER (smaller-y) insert.
        cur = msa
        for (y, base) in inserts:
            col = np.full(r, 4, np.int8)
            if y == cur.shape[1] - 1:
                col[:] = 5                       # after Last_Column
            else:
                nxt = cur[:, y + 1]
                prv = cur[:, y]
                col[(nxt == 5) | (prv == 5)] = 5
            col[k] = base
            cur = _splice_cols(cur, [y + 1], col[None])
        self.msa = cur
        self.counts = symbol_counts(cur)

    def overall_pair(self) -> tuple[int, int]:
        self._drop_empty_columns()
        return overall_score_pair(self.counts)


def _splice_cols(arr: np.ndarray, positions, cols) -> np.ndarray:
    """np.insert(arr, positions, cols, axis=1) for ascending positions
    at memcpy speed. numpy's multi-insert goes through a fancy-index
    assignment over every element; this splices contiguous column
    segments instead. positions are pre-insertion
    indices into arr (np.insert semantics; ties keep given order);
    cols[i] is the inserted column [R].

    Large batches route through the native one-pass row merge: the
    per-segment slice copy touches one cache line per ~8 useful bytes
    when thousands of inserts land in one flush."""
    r, c = arr.shape
    n = len(positions)
    if n > 64 and arr.dtype == np.int8:
        return nat.splice_cols(arr, positions, cols)
    out = np.empty((r, c + n), arr.dtype)
    prev = 0
    for i, p in enumerate(positions):
        out[:, prev + i:p + i] = arr[:, prev:p]
        out[:, p + i] = cols[i]
        prev = p
    out[:, prev + n:] = arr[:, prev:]
    return out


def _splice_rows(arr: np.ndarray, positions, rows) -> np.ndarray:
    """np.insert(arr, positions, rows, axis=0) for ascending positions
    at memcpy speed (see _splice_cols)."""
    c = arr.shape[0]
    n = len(positions)
    out = np.empty((c + n,) + arr.shape[1:], arr.dtype)
    prev = 0
    for i, p in enumerate(positions):
        out[prev + i:p + i] = arr[prev:p]
        out[p + i] = rows[i]
        prev = p
    out[prev + n:] = arr[prev:]
    return out


def validate_counts(msa: np.ndarray, counts: np.ndarray) -> None:
    """The W_Con_Checker invariant (PW_ReAligner.c:765-859): the
    incremental histogram must equal a from-scratch recount."""
    fresh = symbol_counts(msa)
    if not np.array_equal(fresh, counts):
        bad = np.nonzero((fresh != counts).any(axis=1))[0]
        raise AssertionError(
            f"count invariant violated at columns {bad[:10].tolist()}")


def _native():
    """The native host library; the port has no other exact engine."""
    nat.get_lib()           # builds at first use; raises if it cannot
    return nat


def realign_block_native(nat, counts, rows_old, seqs, ways, lengths,
                         bandwidth):
    """Native exact-band block DP, growing the insert buffer until no
    row overflows it. Returns (new_rows, best, ins_y, ins_base, ins_n)."""
    cap = 512
    while True:
        res = nat.realign_block(counts, rows_old, seqs, ways, lengths,
                                bandwidth, ins_cap=cap)
        if not (res[4] >= cap).any():
            return res
        cap = max(cap * 2, int(res[4].max()) + 1)


def _check_inserts(inn: np.ndarray) -> None:
    """The device routes hold MAX_INSERTS inserts a row."""
    if (inn >= br.MAX_INSERTS).any():
        raise RuntimeError("insert buffer overflow; raise MAX_INSERTS or "
                           "use the serial engine")


def compact_rows(rows_old: np.ndarray, lpad: int | None = None):
    """(seqs int8 [B, L], ways int32 [B, L], lengths int32 [B]) of a
    block's rows: each row's bases and their columns, ways edge-padded
    past the row's length. L is the longest row's length, or lpad."""
    bs = rows_old.shape[0]
    pos_list = [np.flatnonzero(r < 4) for r in rows_old]
    lengths = np.array([len(p) for p in pos_list], np.int32)
    lmax = lpad if lpad is not None else max(1, int(lengths.max()))
    seqs = np.zeros((bs, lmax), np.int8)
    ways = np.zeros((bs, lmax), np.int32)
    for b, pos in enumerate(pos_list):
        if len(pos):
            seqs[b, :len(pos)] = rows_old[b, pos]
            ways[b, :len(pos)] = pos
            ways[b, len(pos):] = pos[-1]
    return seqs, ways, lengths


def _bucket(x: int, base: int = 256, steps=(0.75,)) -> int:
    """Padded size of a block's L or C: powers of two from `base` with
    intermediate rungs (the JAX package's buckets; the memory budget
    reads the padded length, so they are part of the trajectory)."""
    v = base
    while v < x:
        v *= 2
    if v > base:
        for f in sorted(steps):
            if v * f >= x:
                return int(v * f)
    return v


def chunk_drift(ways: np.ndarray, chunk: int) -> int:
    """The column-path drift of a block: max over rows and chunks of
    way[chunk end] - way[chunk start]. A staircase window covers every
    reference band of a chunk iff drift <= widen * chunk."""
    starts = np.arange(0, ways.shape[1], chunk)
    ends = np.minimum(starts + chunk - 1, ways.shape[1] - 1)
    return int((ways[:, ends] - ways[:, starts]).max()) if len(starts) \
        else 0


def block_dp(counts, rows_old, seqs, ways, lengths, anf_full, entry_bound,
             ncols: int, *, bandwidth: int, chunk: int, widen: int,
             staircase: bool, kernel: str):
    """The DP of one block on the tensors' device: fill, entry scan and
    backtrack. counts int32 [Cp, 6], rows_old int8 [B, Cp], seqs int8
    [B, L], ways / anf_full int32 [B, L], lengths / entry_bound int32
    [B]. Returns (new_rows [B, Cp], best, ins_y, ins_base, ins_n).

    staircase with kernel "cuda": the staircase fill and the walk
    through their wrappers, the packed time-major codes going straight
    into the walk (kernels A and B on CUDA tensors). staircase with
    kernel "torch": the plain staircase fill, its codes unpacked for the
    lockstep backtrack. Otherwise the exact band in torch ops."""
    cpad = rows_old.shape[1]
    w_codes = bandwidth
    if staircase:
        w_codes = bandwidth + widen * chunk
        if kernel == "cuda":
            codes, fband, fanf = cr.staircase_fill(
                counts, rows_old, seqs, ways, lengths, ncols,
                bandwidth=bandwidth, chunk=chunk, widen=widen)
            return cb.entry_and_backtrack(
                codes, fband, fanf, seqs, anf_full, entry_bound, lengths,
                ncols, cpad=cpad, bandwidth=w_codes, chunk=chunk)
        codes, fband, fanf = sr.staircase_fill(
            counts, rows_old, seqs, ways, lengths, ncols,
            bandwidth=bandwidth, chunk=chunk, widen=widen)
        codes = sr.unpack_codes(codes, seqs.shape[1])
    else:
        codes, fband, fanf = br.banded_fill(
            counts, rows_old, seqs, ways, lengths, ncols,
            bandwidth=bandwidth)
    return br.entry_and_backtrack(
        codes, fband, fanf, seqs, anf_full, entry_bound, lengths, ncols,
        cpad=cpad, bandwidth=w_codes)


def band_starts(ways: np.ndarray, lengths: np.ndarray, bandwidth: int,
                chunk: int, staircase: bool):
    """(anf_full int32 [B, L], entry_bound int32 [B]) of a block: the
    band start of every position (the chunk's window start for the
    staircase) and the entry scan's lowest-exclusive column."""
    bh = bandwidth // 2
    anf = np.maximum(0, ways - bh).astype(np.int32)
    if staircase:
        anf = np.repeat(anf[:, ::chunk], chunk, axis=1)[:, :ways.shape[1]]
    last_way = ways[np.arange(len(lengths)), np.maximum(lengths - 1, 0)]
    return (np.ascontiguousarray(anf),
            np.maximum(-1, last_way - bh).astype(np.int32))


def device_memory_budget(device: torch.device) -> int:
    """Bytes a block's codes may take on `device`: RR_DEVICE_HBM_BUDGET
    (the JAX package's knob) when set; else a quarter of a CUDA device's
    total memory, and the JAX package's 4 GiB on the CPU. Block halving
    changes the Jacobi trajectory, so the default depends on the card's
    model alone, never on what else runs beside the process: the same
    command gives the same score log, and the ranks of a mesh (one card
    model) halve the same blocks."""
    env = os.environ.get("RR_DEVICE_HBM_BUDGET")
    if env:
        return int(env)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return 4 << 30


class BatchedRealigner:
    """Block-Jacobi realigner with the MSA on the host.

    block_rows=1 reproduces the serial reference Gauss-Seidel
    trajectory exactly; larger blocks are block-Jacobi (each row's DP
    sees the sweep-start histogram minus its own contribution) over
    length-sorted blocks, with every insert of the sweep spliced at its
    end.

    mode "exact" | "staircase" and kernel "native" | "torch" | "cuda"
    name the block DP's route (module docstring); `device` is where the
    torch and cuda routes run. mesh: a parallel/sharded.Mesh, the
    block's rows sharded over its ranks (every rank runs the same host
    loop on the same MSA; kernel "native" maps to the torch fill, as
    the JAX package maps it to XLA)."""

    # staircase drift-slack rungs (window lanes = band + widen*chunk),
    # shared with the resident engine's per-block ladder
    WIDEN_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)
    # sweeps of this engine in this process (not the resident
    # subclass's: for it these are the anneal's tail on the host) and
    # their seconds, for reports
    host_sweeps = 0
    host_sweep_s = 0.0
    host_sweep_s_by_bs: dict = {}     # the same seconds by block size

    def __init__(self, msa: np.ndarray, bandwidth: int = 1000,
                 block_rows: int = 8, mode: str = "exact",
                 chunk: int = 256, kernel: str = "native", mesh=None,
                 device: str | torch.device = "cuda"):
        tune_allocator()   # big-MSA splices need warm-page reuse
        if mode not in ("exact", "staircase"):
            raise ValueError(f"unsupported mode {mode!r}")
        if kernel not in ("native", "torch", "cuda"):
            raise ValueError(f"unsupported kernel {kernel!r}")
        self.mesh = mesh
        self._mesh_cache: dict = {}
        self.msa = np.ascontiguousarray(msa, dtype=np.int8)
        self.counts = symbol_counts(self.msa)
        self.bandwidth = bandwidth
        self.block_rows = block_rows
        self.mode = mode
        # wide bands run the kernels at chunk 128 (the JAX engine's
        # choice for its Pallas kernel; any chunk whose slack covers the
        # drift gives the same result)
        self.chunk = min(chunk, 128) if bandwidth >= 768 and \
            kernel == "cuda" else chunk
        self.kernel = kernel
        # the device of the torch and cuda routes; the native route
        # never touches it (so the default stays unresolved there)
        if mesh is not None:
            self.device = mesh.device
        elif kernel == "native" and mode == "exact":
            self.device = device
        else:
            self.device = resolve_device(device)
        self._pending: list | None = None   # sweep-deferred inserts
        # RR_FLUSH_CAP (the JAX package's knob) raises the cap, so that
        # two engines compared at one block size both flush once a sweep
        self._flush_cap = int(os.environ.get("RR_FLUSH_CAP", FLUSH_CAP))
        self._budget = None                 # bytes, read at first use
        self._len_order = None

    def ent_al_gapper(self):
        eng = RealignEngine.__new__(RealignEngine)
        eng.msa = self.msa
        eng.bandwidth = self.bandwidth
        eng.counts = self.counts
        eng.ent_al_gapper()
        self.msa, self.counts = eng.msa, eng.counts

    def _drop_empty(self, min_frac: float = 0.0):
        # a column is empty iff it has no base (read from the counts);
        # min_frac > 0 defers the full-width compaction until empties
        # accumulate (score-neutral, but part of the block>1 trajectory)
        keep = self.counts[:, 0:4].sum(axis=1) > 0
        n_empty = len(keep) - int(keep.sum())
        if n_empty == 0 or n_empty < min_frac * len(keep):
            return
        idx = np.flatnonzero(keep)
        self.msa = np.ascontiguousarray(np.take(self.msa, idx, axis=1))
        self.counts = np.ascontiguousarray(np.take(self.counts, idx,
                                                   axis=0))

    def overall_pair(self):
        self._drop_empty()
        return overall_score_pair(self.counts)

    # engine-polymorphic accessors (the resident engine keeps the MSA on
    # the device and overrides these)
    def best_snapshot(self) -> np.ndarray:
        return self.msa.copy()

    def width(self) -> int:
        return self.msa.shape[1]

    def validate(self) -> None:
        validate_counts(self.msa, self.counts)

    def widen_state(self):
        return None

    def respawn(self, msa: np.ndarray, block_rows: int):
        """A fresh engine of the same kind over `msa` (anneal restart)."""
        return BatchedRealigner(msa, bandwidth=self.bandwidth,
                                block_rows=block_rows, mode=self.mode,
                                chunk=self.chunk, kernel=self.kernel,
                                mesh=self.mesh, device=self.device)

    def shrink(self, block_rows: int):
        """Adopt a smaller Jacobi block size (the anneal's non-restore
        branch); engines may return a replacement."""
        self.block_rows = block_rows
        return self

    def sweep(self) -> None:
        t0 = time.perf_counter()
        self._sweep()
        dt = time.perf_counter() - t0
        BatchedRealigner.host_sweeps += 1
        BatchedRealigner.host_sweep_s += dt
        by_bs = BatchedRealigner.host_sweep_s_by_bs
        by_bs[self.block_rows] = by_bs.get(self.block_rows, 0.0) + dt

    def _sweep(self) -> None:
        r = self.msa.shape[0]
        bs = self.block_rows
        if bs == 1 and self.kernel == "native" and self.mode == "exact":
            self._pending = None
            self._sweep_serial_indirect(_native())
            return
        # block 1 drops empty columns and splices inserted ones at every
        # row (the reference's W_Con and Column_Adder). Larger blocks are
        # Jacobi already: freeze the column geometry for the sweep and
        # splice every insert once at its end
        defer = bs > 1
        self._pending = [] if defer else None
        order = np.arange(r)
        if defer:
            self._drop_empty(min_frac=0.02)
            if self._len_order is None:
                # row base counts are realignment-invariant: sort once,
                # so blocks are length-homogeneous (same rows per sweep)
                lengths_all = (self.msa < 4).sum(axis=1)
                self._len_order = np.argsort(-lengths_all, kind="stable")
            order = self._len_order
        for k0 in range(0, r, bs):
            if not defer:
                self._drop_empty(min_frac=0.0)
            self._realign_block([int(k) for k in order[k0:k0 + bs]])
            if defer and len(self._pending) >= self._flush_cap:
                self._flush_pending()
        if defer:
            self._flush_pending()
            self._pending = None

    def _flush_pending(self) -> None:
        pend = self._pending
        if not pend:
            return
        self._pending = []
        # reference order at one gap: rows in sweep order, reverse
        # discovery within a row (Column_Adder splice order)
        pend.sort(key=lambda t: (t[0], t[1], -t[2]))
        self._do_inserts([(g, k, b) for g, k, o, b in pend])

    def _sweep_serial_indirect(self, nat) -> None:
        """Serial (reference-order Gauss-Seidel) sweep at block_rows=1
        through the native row DP, with the MSA in an over-allocated
        physical column store plus a logical->physical column index: a
        splice is an insert into the index plus one column write into a
        free slot, an empty-column drop the reverse (the reference's
        linked-list W_Con / Column_Adder, PW_ReAligner.c:706-763,
        1245-1332). Bit-identical to the direct block-1 path."""
        msa, counts = self.msa, self.counts
        r, c = msa.shape
        bw = self.bandwidth
        slack = max(4096, c // 8)
        phys = np.empty((r, c + slack), np.int8)
        phys[:, :c] = msa
        phys[:, c:] = 5
        cphys = np.zeros((c + slack, 6), np.int32)
        cphys[:c] = counts
        l2p = np.arange(c, dtype=np.int64)
        free = list(range(c, c + slack))
        for k in range(r):
            # W_Con: free empty columns before every row (counts-read)
            cl = cphys[l2p]
            keep = (cl[:, 0] | cl[:, 1] | cl[:, 2] | cl[:, 3]) > 0
            if not keep.all():
                free.extend(l2p[~keep].tolist())
                l2p = l2p[keep]
                cl = np.ascontiguousarray(cl[keep])
            cc = len(l2p)
            row_old = phys[k, l2p]
            pos = np.nonzero(row_old < 4)[0]
            ln = len(pos)
            if ln:
                way = np.ascontiguousarray(pos[None, :], np.int32)
                seq = np.ascontiguousarray(row_old[pos][None, :])
                lens = np.array([ln], np.int32)
                new_rows, _, iy, ib, inn = realign_block_native(
                    nat, cl, row_old[None], seq, way, lens, bw)
                new = new_rows[0]
            else:
                new = np.full(cc, 5, np.int8)
                iy = ib = None
                inn = np.zeros(1, np.int32)
            d = np.nonzero(row_old != new)[0]
            if len(d):
                pd = l2p[d]
                cphys[pd, row_old[d].astype(np.int64)] -= 1
                cphys[pd, new[d].astype(np.int64)] += 1
                phys[k, pd] = new[d]
            n = int(inn[0])
            if n:
                if len(free) < n:
                    # physical capacity exhausted: compact + regrow
                    grow = max(4096, cc // 8) + n
                    ph2 = np.empty((r, cc + grow), np.int8)
                    ph2[:, :cc] = phys[:, l2p]
                    ph2[:, cc:] = 5
                    c2 = np.zeros((cc + grow, 6), np.int32)
                    c2[:cc] = cphys[l2p]
                    phys, cphys = ph2, c2
                    l2p = np.arange(cc, dtype=np.int64)
                    free = list(range(cc, cc + grow))
                # reverse discovery within the row (Column_Adder splice
                # order); fills for the whole batch are computed against
                # the pre-splice MSA (free slots are invisible through
                # l2p until spliced)
                order = sorted(range(n),
                               key=lambda o: (int(iy[0, o]), -o))
                gaps = np.array([int(iy[0, o]) for o in order], np.int64)
                slots = np.array([free.pop() for _ in range(n)],
                                 np.int64)
                for i in range(n):
                    g = int(gaps[i])
                    p = int(slots[i])
                    if g == cc - 1:
                        phys[:, p] = 5
                    else:
                        nxt = phys[:, l2p[g + 1]]
                        prv = phys[:, l2p[g]]
                        col = np.full(r, 4, np.int8)
                        col[(nxt == 5) | (prv == 5)] = 5
                        phys[:, p] = col
                    phys[k, p] = ib[0, order[i]]
                    cnt = np.bincount(phys[:, p], minlength=6)
                    cphys[p] = cnt[:6]
                l2p = np.insert(l2p, gaps + 1, slots)
        self.msa = np.ascontiguousarray(phys[:, l2p])
        self.counts = np.ascontiguousarray(cphys[l2p])

    def _realign_block(self, rows: list[int]) -> None:
        c = self.msa.shape[1]
        bs = len(rows)
        rows_old = self.msa[rows]                     # [B, C] snapshot
        if self.kernel == "native" and self.mode == "exact" \
                and self.mesh is None:
            seqs, ways, lengths = compact_rows(rows_old)
            new_rows, _best, iy, ib, inn = realign_block_native(
                _native(), self.counts.astype(np.int32), rows_old, seqs,
                ways, lengths, self.bandwidth)
            self._apply_block(rows, new_rows, iy, ib, inn)
            return
        # L and C padded to buckets (the JAX package's: the budget below
        # reads the padded length)
        lmax = max(1, int((rows_old < 4).sum(axis=1).max()))
        lpad = _bucket(lmax)
        cpad = _bucket(c, 512, steps=(0.625, 0.75, 0.875))
        seqs, ways, lengths = compact_rows(rows_old, lpad)

        use_stair = self.mode == "staircase"
        widen = 1
        if use_stair:
            # the staircase window [a, a + W + widen*T) covers every
            # reference band of a chunk iff drift <= widen*T: take the
            # first ladder rung that covers the block's drift, and
            # beyond the ladder (or the kernel's widest window) the
            # exact band, which no drift troubles
            drift = chunk_drift(ways, self.chunk)
            widen = next((v for v in self.WIDEN_LADDER
                          if v * self.chunk >= drift), 0)
            if not widen or (self.kernel == "cuda" and self.bandwidth
                             + widen * self.chunk > cr.MAX_W2):
                use_stair = False
                widen = 1

        if (self.kernel != "native" or self.mesh is not None) and bs > 8:
            # bound the device memory by the codes' footprint: the
            # kernels emit 2-bit packed codes (lpad*bs*w2/4 bytes; factor
            # 1/2 with headroom), the torch fills unpacked codes plus
            # the chunk's cost windows (factor 2). Halve the block until
            # it fits: smaller Jacobi blocks keep the convergence
            # contract but change the trajectory. On a mesh a rank holds
            # bs/n rows of the codes.
            w2max = (self.bandwidth + widen * self.chunk
                     if use_stair else self.bandwidth)
            factor = 0.5 if (use_stair and self.kernel == "cuda") else 2.0
            nshard = self.mesh.size if self.mesh is not None else 1
            if factor * lpad * (bs / nshard) * w2max > self._memory_budget():
                h = (bs // 2 + 7) // 8 * 8
                self._realign_block(rows[:h])
                self._realign_block(rows[h:])
                return
        if self.mesh is not None:
            self._realign_block_mesh(rows, rows_old, lengths, seqs, ways,
                                     c, cpad, use_stair, widen)
            return

        counts_p = np.zeros((cpad, 6), np.int32)
        counts_p[:c] = self.counts
        rows_p = np.full((bs, cpad), 5, np.int8)
        rows_p[:, :c] = rows_old
        anf_full, entry_bound = band_starts(ways, lengths, self.bandwidth,
                                            self.chunk, use_stair)
        dev = self.device
        new_rows, _best, iy, ib, inn = block_dp(
            *(torch.from_numpy(a).to(dev) for a in (
                counts_p, rows_p, seqs, ways, lengths, anf_full,
                entry_bound)), c, bandwidth=self.bandwidth,
            chunk=self.chunk, widen=widen, staircase=use_stair,
            kernel=self.kernel)
        inn = inn.cpu().numpy()
        _check_inserts(inn)
        self._apply_block(rows, new_rows[:, :c].cpu().numpy(),
                          iy.cpu().numpy(), ib.cpu().numpy(), inn)

    def _memory_budget(self) -> int:
        """The block's memory budget in bytes, read once."""
        if self._budget is None:
            self._budget = device_memory_budget(self.device)
        return self._budget

    def _realign_block_mesh(self, rows, rows_old, lengths, seqs, ways,
                            c, cpad, stair: bool, widen: int) -> None:
        """The block step on a mesh: rows data-parallel over the ranks,
        the histogram replicated, the delta summed over the ranks
        (parallel/sharded.sharded_block_realign). The block is padded to
        a multiple of the mesh size with duplicates of row 0, whose
        outputs are dropped and whose delta is masked out, so the
        trajectory equals the single-process one.

        stair and widen are `_realign_block`'s choice: a block that no
        ladder rung covers, or whose window passes kernel A's MAX_W2 on
        kernel "cuda", runs the exact band here too, so the mesh
        trajectory is bit-equal to the single-process one. (The JAX
        package's mesh step takes the top rung for such a block instead,
        a window that does not cover its drift, and departs from its
        single-process run there.)"""
        from ..parallel import sharded
        bs = len(rows)
        n = self.mesh.size
        kern = "cuda" if self.kernel == "cuda" and stair else "torch"
        bpad = -(-bs // n) * n
        if bpad != bs:
            p = bpad - bs
            rows_old = np.concatenate(
                [rows_old, np.repeat(rows_old[:1], p, axis=0)])
            seqs = np.concatenate([seqs, np.repeat(seqs[:1], p, axis=0)])
            ways = np.concatenate([ways, np.repeat(ways[:1], p, axis=0)])
            lengths = np.concatenate([lengths, np.repeat(lengths[:1], p)])
        counts_p = np.zeros((cpad, 6), np.int32)
        counts_p[:c] = self.counts
        rows_p = np.full((bpad, cpad), 5, np.int8)
        rows_p[:, :c] = rows_old
        anf_full, entry_bound = band_starts(ways, lengths, self.bandwidth,
                                            self.chunk, stair)
        valid = np.zeros(bpad, np.int32)
        valid[:bs] = 1
        mode = "staircase" if stair else "exact"
        key = (mode, widen, kern)
        step = self._mesh_cache.get(key)
        if step is None:
            step = self._mesh_cache[key] = sharded.sharded_block_realign(
                self.mesh, self.bandwidth, mode=mode,
                chunk=self.chunk, widen=widen, kernel=kern)
        new_rows, iy, ib, inn, delta = step(
            counts_p, rows_p, seqs, ways, lengths, anf_full, entry_bound,
            valid, c)
        _check_inserts(inn[:bs])
        self._apply_block(rows, new_rows[:bs, :c], iy[:bs], ib[:bs],
                          inn[:bs], delta=delta[:c])

    def _apply_block(self, rows, new_rows, iy, ib, inn, delta=None) -> None:
        """Replace rows, update counts incrementally (one bincount over
        (col, sym) pairs per block, or the mesh step's summed delta),
        and queue or splice the inserted columns."""
        msa, counts = self.msa, self.counts
        if delta is not None:
            counts += delta
            msa[rows] = new_rows
        else:
            old_idx, new_idx = [], []
            for b, k in enumerate(rows):
                old = msa[k]
                new = new_rows[b]
                d = np.nonzero(old != new)[0]
                old_idx.append(d * 6 + old[d])
                new_idx.append(d * 6 + new[d])
                msa[k] = new
            c6 = counts.shape[0] * 6
            sub = np.bincount(np.concatenate(old_idx), minlength=c6)
            add = np.bincount(np.concatenate(new_idx), minlength=c6)
            counts += (add - sub).reshape(-1, 6)
        all_ins = []  # (gap, row, discovery order, base)
        for b, k in enumerate(rows):
            for o in range(int(inn[b])):
                all_ins.append((int(iy[b, o]), k, o, int(ib[b, o])))
        if not all_ins:
            return
        if self._pending is not None:       # sweep-end batch (see sweep)
            self._pending.extend(all_ins)
            return
        all_ins.sort(key=lambda t: (t[0], t[1], -t[2]))
        self._do_inserts([(g, k, b) for g, k, o, b in all_ins])

    def _do_inserts(self, ins) -> None:
        """Splice inserted columns (each its own column, reference
        semantics: other rows get ' ' next to a coverage gap, else '-').
        ins: [(gap, row, base)] in splice order; fills are computed
        against the pre-splice MSA for the whole batch."""
        if not ins:
            return
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        r_all = msa.shape[0]
        positions = []
        cols = []
        for gap, k, base in ins:
            col = np.full(r_all, 4, np.int8)
            if gap == c - 1:
                col[:] = 5
            else:
                col[(msa[:, gap + 1] == 5) | (msa[:, gap] == 5)] = 5
            col[k] = base
            positions.append(gap + 1)
            cols.append(col)
        cols_arr = np.stack(cols)                 # [n_ins, R]
        self.msa = _splice_cols(msa, positions, cols_arr)
        col_counts = np.stack(
            [np.bincount(col, minlength=6) for col in cols_arr]
        ).astype(counts.dtype)
        self.counts = _splice_rows(counts, positions, col_counts)


def realign_batched(msa: np.ndarray, cfg: RealignerConfig,
                    out_path=None, score_log: list | None = None,
                    block_rows: int | None = None,
                    checkpoint_path: str | None = None,
                    resume: bool = False,
                    stats: dict | None = None,
                    validate: bool = False,
                    mode: str = "auto",
                    kernel: str = "auto",
                    score_log_path: str | None = None,
                    mesh=None,
                    anneal: bool = True,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """The realign main loop (PW_ReAligner.c:1681-1747): sweep until a
    round fails to improve the (mille, uno) score pair, keeping the best
    MSA. With checkpoint_path the state is saved atomically per
    improving round (the reference's best-MSA-per-round semantics; on
    the resident engine at most every RR_BEST_WRITE_S seconds, 600 by
    default, as in the JAX package), and resume=True restarts from it,
    also from a checkpoint the JAX package wrote. score_log_path: one
    line a round, "round score width" (OverallScorePrintF,
    PW_ReAligner.c:965-1007).

    mode "auto" is the staircase band (the exact band with kernel
    "native"); kernel "auto" is "cuda" for the staircase and, for the
    exact band, "torch" on a CUDA device and "native" on the CPU. The
    staircase with kernel "cuda" above block 1 runs the resident engine
    (kernels A and B) on `device`: "cuda", or "cpu" for the plain torch
    versions; RR_RESIDENT=0 keeps the MSA on the host instead
    (`BatchedRealigner`). Under "auto", block 1 runs on the host native
    engine, and kernel="auto" hands a run resumed inside the anneal's
    tail (a block size below RESIDENT_MIN_BS) to it too, as the
    resident engine's own shrink() does; kernel="cuda" keeps such a run
    on the resident engine (the JAX package's explicit "pallas").

    mesh: a parallel/sharded.Mesh. Each block's rows are sharded over
    its ranks, the histogram delta summed over them, on the
    non-resident engine; every rank runs this loop on the same MSA and
    returns the same result, and rank 0 alone writes out_path, the
    score log and the checkpoint. The trajectory equals the
    single-process one.

    anneal: block-Jacobi sweeps can stall in a worse local optimum than
    the reference's serial Gauss-Seidel. With anneal=True the first
    non-improving round at block B restores the best MSA (when the
    stalled round left it worse) and continues at B//4, ending when a
    block-1 round (the reference's serial semantics) fails to improve.

    stats, when given, receives the JAX package's keys: rounds, wall_s
    (host clock from after EntAlGapper to the return), dp_cells (bases x
    band per sweep) and cells_per_s."""
    from .realigner_device import DeviceResidentRealigner

    start_round = 0
    best = (1 << 62, 0)
    ck_bs = 0
    ck_widen_state = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        c = ckpt.RealignCheckpoint.load(checkpoint_path)
        msa = c.msa
        start_round = c.round
        best = (c.best_mille, c.best_uno)
        ck_bs = c.block_rows              # the anneal position
        if c.widen is not None:           # the learned drift ladder
            ck_widen_state = (c.widen_bs, c.widen,
                              tuple(int(b) for b in c.exact_blocks))

    if mode not in ("auto", "exact", "staircase"):
        raise ValueError(f"unsupported mode {mode!r}")
    if kernel not in ("auto", "native", "torch", "cuda"):
        raise ValueError(f"unsupported kernel {kernel!r}")
    if mesh is not None:
        device = mesh.device
    auto = kernel == "auto" or mode == "auto"
    bs = ck_bs or block_rows or cfg.block_rows
    if (auto and bs == 1) or (
            kernel == "auto" and ck_bs
            and ck_bs < DeviceResidentRealigner.RESIDENT_MIN_BS):
        # the anneal's tail (1 = the reference's serial Gauss-Seidel)
        mode, kernel = "exact", "native"
    if mode == "auto":
        mode = "exact" if kernel == "native" else "staircase"
    if kernel == "auto":
        kernel = ("cuda" if mode == "staircase" else
                  "native" if torch.device(device).type == "cpu" else
                  "torch")
    resident = (kernel == "cuda" and mode == "staircase" and mesh is None
                and bs > 1 and os.environ.get("RR_RESIDENT", "1") != "0")
    if resident:
        eng = DeviceResidentRealigner(msa, bandwidth=cfg.bandwidth,
                                      block_rows=bs, device=device,
                                      widen_state=ck_widen_state)
    else:
        eng = BatchedRealigner(msa, bandwidth=cfg.bandwidth, block_rows=bs,
                               mode=mode, kernel=kernel, mesh=mesh,
                               device=device)
    # on a mesh every rank runs the loop; rank 0 alone writes files
    writes = mesh is None or mesh.rank == 0
    eng.ent_al_gapper()
    best_msa = None
    rounds = start_round
    # row base counts are realignment-invariant: the DP cells of a sweep
    bases = int((np.asarray(msa) < 4).sum())
    cells = 0
    t0 = time.perf_counter()
    writer: list = [None]         # in-flight best-MSA write thread

    # an engine whose snapshots are costly (the resident engine: each
    # write downloads and encodes the whole MSA) writes at most once
    # every RR_BEST_WRITE_S seconds, the JAX package's variable and
    # default; the files are crash recovery, and the final state is
    # always written on return. Re-read a write: the anneal hands the
    # tail to a host engine, whose snapshots are cheap
    def _write_interval():
        return (float(os.environ.get("RR_BEST_WRITE_S", "600"))
                if getattr(eng, "SNAPSHOT_COSTLY", False) else 0.0)

    last_write = [-float("inf")]
    write_stale = [False]         # best_msa newer than the last write

    def _eng_state():
        """The checkpoint's engine state: the block size (anneal
        position) and the resident engine's learned drift ladder."""
        return (int(eng.block_rows), eng.widen_state())

    def _write_best(snapshot, pair, rnd, state):
        if not writes:
            return
        tw = time.perf_counter()
        if out_path is not None:
            rio.write_msa(out_path, snapshot, upper=True)
        if checkpoint_path is not None:
            e_bs, ws = state
            ckpt.RealignCheckpoint(
                msa=snapshot, round=rnd, best_mille=pair[0],
                best_uno=pair[1], bandwidth=cfg.bandwidth,
                block_rows=e_bs,
                widen_bs=ws[0] if ws else 0,
                widen=ws[1] if ws else None,
                exact_blocks=np.asarray(ws[2], np.int64) if ws
                else None).save(checkpoint_path)
        realign_batched.write_s.append(time.perf_counter() - tw)

    def _join_writer():
        if writer[0] is not None:
            tj = time.perf_counter()
            writer[0].join()
            realign_batched.write_wait_s += time.perf_counter() - tj

    def check_improved(write=True):
        nonlocal best, best_msa
        pair = eng.overall_pair()
        if score_log is not None:
            score_log.append(pair)
        if score_log_path is not None and writes:
            with open(score_log_path, "a") as f:
                f.write(f"{rounds} {pair[0]}{pair[1]:06d} "
                        f"{eng.width()}\n")
        if pair < best:
            best = pair
            best_msa = eng.best_snapshot()
            write_stale[0] = True
            if write and (out_path is not None
                          or checkpoint_path is not None):
                if time.perf_counter() - last_write[0] \
                        < _write_interval():
                    return True
                # overlap the best-MSA write with the next sweep; at
                # most one write is in flight
                _join_writer()
                last_write[0] = time.perf_counter()
                write_stale[0] = False
                writer[0] = threading.Thread(
                    target=_write_best,
                    args=(best_msa, best, rounds, _eng_state()),
                    daemon=True)
                writer[0].start()
            return True
        return False

    check_improved(write=False)
    if checkpoint_path is not None and start_round == 0 and writes:
        # round-0 checkpoint right after EntAlGapper
        ckpt.RealignCheckpoint(
            msa=eng.msa, round=0, best_mille=best[0], best_uno=best[1],
            bandwidth=cfg.bandwidth).save(checkpoint_path)
    while rounds < cfg.max_rounds:
        cells += bases * cfg.bandwidth
        eng.sweep()
        rounds += 1
        if validate:
            eng.validate()
        if not check_improved():
            if anneal and eng.block_rows > 1:
                nb = max(1, eng.block_rows // 4)
                if best_msa is not None and eng.overall_pair() > best:
                    # the stalled Jacobi round left the MSA worse than
                    # the best: polish from the best
                    eng = eng.respawn(np.asarray(best_msa).copy(), nb)
                else:
                    eng = eng.shrink(nb)
                continue
            break
    eng.ent_al_gapper()
    check_improved()
    _join_writer()                # files must be complete on return
    if write_stale[0] and best_msa is not None \
            and (out_path is not None or checkpoint_path is not None):
        # a throttled (or the initial) best was never written: write it
        _write_best(best_msa, best, rounds, _eng_state())
    if stats is not None:
        dt = time.perf_counter() - t0
        stats.update(rounds=rounds, wall_s=dt, dp_cells=cells,
                     cells_per_s=cells / dt if dt > 0 else 0.0)
    return (np.asarray(best_msa) if best_msa is not None
            else eng.msa)


# seconds of each best-MSA write (MSA text and checkpoint, on the writer
# thread) and seconds the loop waited for the write in flight, for
# reports
realign_batched.write_s = []
realign_batched.write_wait_s = 0.0


def realign(msa: np.ndarray, cfg: RealignerConfig,
            out_path=None, score_log: list | None = None) -> np.ndarray:
    """The reference main loop (PW_ReAligner.c:1610-1759), serial mode.

    Returns the best MSA (also written to out_path per improving round
    when given, reproducing the reference's checkpoint-every-improving-
    round semantics)."""
    eng = RealignEngine(msa, bandwidth=cfg.bandwidth)
    eng.ent_al_gapper()
    best = (1 << 62, 0)
    best_msa = None

    def check_improved(write=True):
        nonlocal best, best_msa
        pair = eng.overall_pair()
        if score_log is not None:
            score_log.append(pair)
        if pair < best:
            best = pair
            best_msa = eng.msa.copy()
            if write and out_path is not None:
                rio.write_msa(out_path, best_msa, upper=True)
            return True
        return False

    # The reference prints (and records best) before round 1 but only
    # writes the output after an improving ROUND (main :1741).
    check_improved(write=False)
    rounds = 0
    while rounds < cfg.max_rounds:
        for k in range(eng.msa.shape[0]):
            eng.realign_row(k)
        rounds += 1
        if not check_improved():
            break
    eng.ent_al_gapper()
    if check_improved():
        pass
    return best_msa if best_msa is not None else eng.msa
