"""Sum-of-pairs MSA refinement (the reference's PW_ReAligner), host side.

Counterpart of repeatresolver_tpu/models/realigner.py. Two pieces live
here:

  * `BatchedRealigner`, the host native engine: the exact band through
    the native C++ block DP (repeatresolver_tpu/utils/native.
    realign_block), block-Jacobi over length-sorted blocks with the
    inserts of a sweep spliced at its end; block_rows=1 is the
    reference's serial Gauss-Seidel sweep. It runs the anneal's tail
    (block sizes below the resident engine's threshold) and the
    resident engine's exact blocks.
  * `realign_batched`, the main loop: best tracking, the anneal,
    checkpoints and resume.

The staircase band equals the exact band for any covering slack, and at
a fixed block size the Jacobi trajectory does not depend on the kernel,
so the two engines are interchangeable mid-run (the anneal hands the
resident engine's MSA to this one).

The dense-array bookkeeping (histogram, score pair, EntAlGapper, column
splices) is imported from the JAX package's module, which is jax-free
at its top; its engine classes are not used, because their sweeps reach
the JAX kernels.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from repeatresolver_tpu.config import RealignerConfig
from repeatresolver_tpu.models.realigner import (RealignEngine,
                                                 _splice_cols, _splice_rows,
                                                 overall_score_pair,
                                                 symbol_counts,
                                                 validate_counts)

__all__ = ["BatchedRealigner", "realign_batched", "overall_score_pair",
           "symbol_counts", "validate_counts"]

# pending inserts before a mid-sweep flush: a memory bound, but a sweep
# that crosses it flushes mid-sweep, which changes the block>1 Jacobi
# trajectory (same value as the JAX package, so trajectories match)
FLUSH_CAP = 16384


def _native():
    """The native host library; the port has no other exact engine."""
    from repeatresolver_tpu.utils import native as nat
    lib = nat.get_lib()
    if lib is None or not hasattr(lib, "realign_block_native"):
        raise RuntimeError(
            "native host library unavailable (native/libhostops.so could "
            "not be loaded or built with g++); the exact realign path "
            "needs it")
    return nat


def realign_block_native(nat, counts, rows_old, seqs, ways, lengths,
                         bandwidth):
    """Native exact-band block DP, growing the insert buffer until no
    row overflows it. Returns (new_rows, best, ins_y, ins_base, ins_n)."""
    cap = 512
    while True:
        res = nat.realign_block(counts, rows_old, seqs, ways, lengths,
                                bandwidth, ins_cap=cap)
        if res is None:
            raise RuntimeError("native realign_block unavailable")
        if not (res[4] >= cap).any():
            return res
        cap = max(cap * 2, int(res[4].max()) + 1)


def compact_rows(rows_old: np.ndarray):
    """(seqs int8 [B, L], ways int32 [B, L], lengths int32 [B]) of a
    block's rows: each row's bases and their columns, ways edge-padded
    past the row's length."""
    bs = rows_old.shape[0]
    pos_list = [np.flatnonzero(r < 4) for r in rows_old]
    lengths = np.array([len(p) for p in pos_list], np.int32)
    lmax = max(1, int(lengths.max()))
    seqs = np.zeros((bs, lmax), np.int8)
    ways = np.zeros((bs, lmax), np.int32)
    for b, pos in enumerate(pos_list):
        if len(pos):
            seqs[b, :len(pos)] = rows_old[b, pos]
            ways[b, :len(pos)] = pos
            ways[b, len(pos):] = pos[-1]
    return seqs, ways, lengths


class BatchedRealigner:
    """Host native engine (exact band, native C++ block DP).

    block_rows=1 reproduces the serial reference Gauss-Seidel
    trajectory exactly; larger blocks are block-Jacobi (each row's DP
    sees the sweep-start histogram minus its own contribution) over
    length-sorted blocks, with every insert of the sweep spliced at its
    end."""

    # staircase drift-slack rungs (window lanes = band + widen*chunk),
    # shared with the resident engine's per-block ladder
    WIDEN_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)
    # host sweeps run in this process (the anneal's tail) and their
    # seconds, for reports
    host_sweeps = 0
    host_sweep_s = 0.0

    def __init__(self, msa: np.ndarray, bandwidth: int = 1000,
                 block_rows: int = 8):
        from repeatresolver_tpu.utils.hostmem import tune_allocator
        tune_allocator()   # big-MSA splices need warm-page reuse
        self.msa = np.ascontiguousarray(msa, dtype=np.int8)
        self.counts = symbol_counts(self.msa)
        self.bandwidth = bandwidth
        self.block_rows = block_rows
        self._pending: list | None = None   # sweep-deferred inserts
        self._flush_cap = FLUSH_CAP
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

    def validate(self) -> None:
        validate_counts(self.msa, self.counts)

    def widen_state(self):
        return None

    def respawn(self, msa: np.ndarray, block_rows: int):
        """A fresh engine of the same kind over `msa` (anneal restart)."""
        return BatchedRealigner(msa, bandwidth=self.bandwidth,
                                block_rows=block_rows)

    def shrink(self, block_rows: int):
        """Adopt a smaller Jacobi block size (the anneal's non-restore
        branch); engines may return a replacement."""
        self.block_rows = block_rows
        return self

    def sweep(self) -> None:
        nat = _native()
        t0 = time.perf_counter()
        self._sweep(nat)
        BatchedRealigner.host_sweeps += 1
        BatchedRealigner.host_sweep_s += time.perf_counter() - t0

    def _sweep(self, nat) -> None:
        r = self.msa.shape[0]
        bs = self.block_rows
        if bs == 1:
            self._pending = None
            self._sweep_serial_indirect(nat)
            return
        # block>1 is Jacobi already: freeze the column geometry for the
        # sweep and splice every insert once at its end
        self._pending = []
        self._drop_empty(min_frac=0.02)
        if self._len_order is None:
            # row base counts are realignment-invariant: sort once, so
            # blocks are length-homogeneous (same rows per sweep)
            lengths_all = (self.msa < 4).sum(axis=1)
            self._len_order = np.argsort(-lengths_all, kind="stable")
        order = self._len_order
        for k0 in range(0, r, bs):
            self._realign_block([int(k) for k in order[k0:k0 + bs]], nat)
            if len(self._pending) >= self._flush_cap:
                self._flush_pending()
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

    def _realign_block(self, rows: list[int], nat) -> None:
        rows_old = self.msa[rows]                     # [B, C] snapshot
        seqs, ways, lengths = compact_rows(rows_old)
        new_rows, _best, iy, ib, inn = realign_block_native(
            nat, self.counts.astype(np.int32), rows_old, seqs, ways,
            lengths, self.bandwidth)
        self._apply_block(rows, new_rows, iy, ib, inn)

    def _apply_block(self, rows, new_rows, iy, ib, inn) -> None:
        """Replace rows, update counts incrementally (one bincount over
        (col, sym) pairs per block), and queue or splice the inserted
        columns."""
        msa, counts = self.msa, self.counts
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
                    kernel: str = "auto",
                    device: str = "cuda") -> np.ndarray:
    """The realign main loop (PW_ReAligner.c:1681-1747): sweep until a
    round fails to improve the (mille, uno) score pair, keeping the best
    MSA. With checkpoint_path the state is saved atomically per
    improving round (the reference's best-MSA-per-round semantics), and
    resume=True restarts from it, also from a checkpoint the JAX package
    wrote.

    Block sizes above 1 run the resident engine (staircase band, kernels
    A and B) on `device`: "cuda", or "cpu" for the plain torch versions.
    kernel="auto" hands a run resumed inside the anneal's tail (a block
    size below RESIDENT_MIN_BS) to the host native engine, as the
    resident engine's own shrink() does; kernel="cuda" keeps such a run
    on the resident engine (the JAX package's explicit "pallas"). Block
    1 runs on the host native engine either way.

    The anneal: the first non-improving round at block B restores the
    best MSA (when the stalled round left it worse) and continues at
    B//4, ending when a block-1 round (the reference's serial
    semantics) fails to improve.

    stats, when given, receives the JAX package's keys: rounds, wall_s
    (host clock from after EntAlGapper to the return), dp_cells (bases x
    band per sweep) and cells_per_s."""
    from repeatresolver_tpu.utils import checkpoint as ckpt
    from repeatresolver_tpu.utils import io as rio

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

    if kernel not in ("auto", "cuda"):
        raise ValueError(f"unsupported kernel {kernel!r}")
    bs = ck_bs or block_rows or cfg.block_rows
    if bs == 1 or (kernel == "auto" and ck_bs
                   and ck_bs < DeviceResidentRealigner.RESIDENT_MIN_BS):
        # the anneal's tail (1 = the reference's serial Gauss-Seidel)
        eng = BatchedRealigner(msa, bandwidth=cfg.bandwidth,
                               block_rows=bs)
    else:
        eng = DeviceResidentRealigner(msa, bandwidth=cfg.bandwidth,
                                      block_rows=bs, device=device,
                                      widen_state=ck_widen_state)
    eng.ent_al_gapper()
    best_msa = None
    rounds = start_round
    # row base counts are realignment-invariant: the DP cells of a sweep
    bases = int((np.asarray(msa) < 4).sum())
    cells = 0
    t0 = time.perf_counter()
    writer: list = [None]         # in-flight best-MSA write thread
    write_stale = [False]         # best_msa newer than the last write

    def _eng_state():
        """The checkpoint's engine state: the block size (anneal
        position) and the resident engine's learned drift ladder."""
        return (int(eng.block_rows), eng.widen_state())

    def _write_best(snapshot, pair, rnd, state):
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

    def check_improved(write=True):
        nonlocal best, best_msa
        pair = eng.overall_pair()
        if score_log is not None:
            score_log.append(pair)
        if pair < best:
            best = pair
            best_msa = eng.best_snapshot()
            write_stale[0] = True
            if write and (out_path is not None
                          or checkpoint_path is not None):
                # overlap the best-MSA write with the next sweep; at
                # most one write is in flight
                if writer[0] is not None:
                    writer[0].join()
                write_stale[0] = False
                writer[0] = threading.Thread(
                    target=_write_best,
                    args=(best_msa, best, rounds, _eng_state()),
                    daemon=True)
                writer[0].start()
            return True
        return False

    check_improved(write=False)
    if checkpoint_path is not None and start_round == 0:
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
            if eng.block_rows > 1:
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
    if writer[0] is not None:     # files must be complete on return
        writer[0].join()
    if write_stale[0] and best_msa is not None \
            and (out_path is not None or checkpoint_path is not None):
        # the initial best was never superseded: write it
        _write_best(best_msa, best, rounds, _eng_state())
    if stats is not None:
        dt = time.perf_counter() - t0
        stats.update(rounds=rounds, wall_s=dt, dp_cells=cells,
                     cells_per_s=cells / dt if dt > 0 else 0.0)
    return (np.asarray(best_msa) if best_msa is not None
            else eng.msa)
