"""Device-resident realignment engine: the MSA lives in device memory.

Counterpart of repeatresolver_tpu/models/realigner_device.py. The whole
MSA (int8 [R, CPAD]) and its column histogram (int32 [CPAD, 6]) stay on
the device, in logical column order, with capacity slack CPAD >= ncols
that grows in place when a splice needs it. A sweep runs one
`block_step` per block of length-sorted rows:

  * gather the block's rows and compact each into (seqs, ways): its
    bases and their columns;
  * kernel A, the staircase fill (ops/cuda_realign.py);
  * the entry scan, then kernel B, the walk backtrack, and the rebuild
    of the rows and insert lists (ops/cuda_backtrack.py);
  * write the rewritten rows back in place and add the histogram delta
    (the reference's Columns_Downdater / Column_Updater,
    PW_ReAligner.c:1172-1243).

The engine uploads the MSA when it is made and makes the call's
whole-MSA passes on that copy: the histogram and the row lengths as
each row chunk lands (`upload_msa`), then both EntAlGapper calls
(`ent_al_gapper_device`, the drop as one column gather); the host gets
the [C, 6] counts and the R row lengths, and the MSA itself only from
`best_snapshot` (and `shrink`, the hand-off to the anneal's tail).

Each step returns one small int32 buffer (insert codes, insert counts,
drift) that the host reads three blocks behind the dispatch; at sweep
end the host builds the splice-and-drop plan (Column_Adder / W_Con,
PW_ReAligner.c:1245-1332, 706-763) and applies it as one device gather.

The staircase slack (`widen`) is adapted per block: every block runs
one ladder rung above its last measured drift. Its actual drift is
checked when its buffer is read; a block whose drift exceeded its slack
(or whose insert list overflowed the fetched window) makes the sweep
restore its start snapshot and redo, wider or through the exact band
(`_exact_block`: kernels F and G in place on a CUDA device, the host
native engine for an engine on the CPU). Kernel A holds a window of at
most `cuda_realign.MAX_W2` lanes, so a block's slack is capped at the
widest rung whose window bandwidth + widen * chunk fits: at dispatch,
where `_drain` raises it, and in the redo set. A block whose drift no fitting rung covers goes
through the exact band for good, as `BatchedRealigner._realign_block`
sends it. Since the staircase equals the exact band for any covering
slack, the per-sweep (mille, uno) trajectory and the final MSA are
bit-equal to the JAX engine's (tests/test_torch_realigner_device.py,
tests/test_torch_wide_band.py).
"""
from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_backtrack as cb
from ..ops import cuda_exact as ce
from ..ops import cuda_realign as cr
from ..ops import staircase_realign as sr
from ..utils import trace
from ..utils.native import NativeBuildError
from .realigner import (BatchedRealigner, _bucket, _check_inserts,
                        _native, band_starts, block_dp, compact_rows,
                        device_memory_budget, exact_block_dp,
                        overall_score_pair, realign_block_native,
                        tail_kernel, validate_counts)

# insert slots fetched per row and block (a row inserts ~0-5 columns per
# sweep; a row overflowing it reroutes its block, see _drain)
MAX_INSERTS_FETCH = 512
# the slack every block starts at, before its drift is measured
DEFAULT_WIDEN = 12
# bytes a cell of a whole-MSA pass may take in temporaries (EntAlGapper's
# masks and int32 column indices): a pass takes as many rows at once as
# keep them within device_memory_budget
PASS_BYTES_PER_CELL = 16


def _hist(rows: torch.Tensor) -> torch.Tensor:
    """int32 [C, 6] symbol histogram of int8 rows [B, C]."""
    return torch.stack([(rows == s).sum(dim=0, dtype=torch.int32)
                        for s in range(6)], dim=1)


def pass_rows(device: torch.device, cols: int) -> int:
    """Rows a whole-MSA pass over `cols` columns takes at once on
    `device`."""
    return max(1, device_memory_budget(device)
               // (PASS_BYTES_PER_CELL * max(cols, 1)))


def upload_msa(msa: np.ndarray, device: torch.device):
    """(msa_d int8 [R, C], counts_d int32 [C, 6], lengths_d int32 [R]):
    the MSA on `device`, uploaded a row chunk at a time, with its symbol
    histogram (`symbol_counts`'s) and each row's bases (`row_lengths`')
    counted there as each chunk lands."""
    r, c = msa.shape
    msa_d = torch.empty((r, c), dtype=torch.int8, device=device)
    counts_d = torch.zeros((c, 6), dtype=torch.int32, device=device)
    lengths_d = torch.empty(r, dtype=torch.int32, device=device)
    step = pass_rows(device, c)
    for k0 in range(0, r, step):
        m = msa_d[k0:k0 + step]
        m.copy_(torch.from_numpy(msa[k0:k0 + step]))
        counts_d += _hist(m)
        lengths_d[k0:k0 + step] = (m < 4).sum(dim=1, dtype=torch.int32)
    return msa_d, counts_d, lengths_d


def ent_al_gapper_device(msa_d: torch.Tensor, counts_d: torch.Tensor,
                         ncols: int) -> int:
    """EntAlGapper's conversion in place on the device: in each row,
    every '-' (4) before its first base or after its last becomes ' '
    (5), and the histogram's counts move from symbol 4 to 5. A row
    without bases has first = ncols and last = -1, as on the host
    (`RealignEngine.ent_al_gapper`, before its drop). msa_d int8
    [R, >= ncols], counts_d int32 [>= ncols, 6]. Returns the cells
    converted."""
    dev = msa_d.device
    cols = torch.arange(ncols, dtype=torch.int32, device=dev)[None, :]
    conv_cols = torch.zeros(ncols, dtype=torch.int32, device=dev)
    step = pass_rows(dev, ncols)
    for k0 in range(0, msa_d.shape[0], step):
        m = msa_d[k0:k0 + step, :ncols]
        base = m < 4
        first = torch.where(base, cols, ncols).amin(dim=1, keepdim=True)
        last = torch.where(base, cols, -1).amax(dim=1, keepdim=True)
        conv = ((cols < first) | (cols > last)) & (m == 4)
        m.masked_fill_(conv, 5)
        conv_cols += conv.sum(dim=0, dtype=torch.int32)
    counts_d[:ncols, 4] -= conv_cols
    counts_d[:ncols, 5] += conv_cols
    return int(conv_cols.sum(dtype=torch.int64))


def kept_columns(counts_d: torch.Tensor, ncols: int) -> torch.Tensor:
    """int64 ids of the columns that hold a base, on the device."""
    return torch.nonzero(counts_d[:ncols, :4].sum(dim=1) > 0).squeeze(1)


def apply_rows(msa_d, counts_d, rows, rows_old, new_rows) -> None:
    """In place: write the rewritten rows and add the histogram delta.
    rows int64 [B] (distinct row ids); rows_old / new_rows int8
    [B, CPAD]."""
    counts_d += _hist(new_rows) - _hist(rows_old)
    msa_d.index_copy_(0, rows, new_rows)


def compact_block(rows_old: torch.Tensor, lengths: torch.Tensor,
                  lpad: int):
    """(seqs int8 [B, lpad], ways int32 [B, lpad], last_way int32 [B])
    of a block's rows on their device: each row's bases and their
    columns (cumsum + one scatter, non-bases into a sentinel column
    sliced off), ways edge-padded past the row's length, and the column
    of its last base (0 for an empty row)."""
    b, cpad = rows_old.shape
    dev = rows_old.device
    isb = rows_old < 4
    pos = torch.cumsum(isb, dim=1, dtype=torch.int32) - 1
    tgt = torch.where(isb & (pos < lpad), pos, lpad).long()
    cols = torch.arange(cpad, dtype=torch.int32, device=dev)[None, :]
    buf = torch.zeros((b, lpad + 1), dtype=torch.int32, device=dev)
    buf.scatter_(1, tgt, (cols << 2) | rows_old.to(torch.int32))
    buf = buf[:, :lpad]
    xs = torch.arange(lpad, dtype=torch.int32, device=dev)[None, :]
    inlen = xs < lengths[:, None]
    last_way = torch.gather(buf >> 2, 1,
                            (lengths - 1).clamp(min=0).long()[:, None])
    ways = torch.where(inlen, buf >> 2, last_way).contiguous()
    seqs = torch.where(inlen, buf & 3, 0).to(torch.int8)
    return seqs, ways, last_way[:, 0].contiguous()


def block_step(msa_d, counts_d, rows, lengths, ncols: int, *,
               bandwidth: int, chunk: int, widen: int, lpad: int,
               maxf: int) -> torch.Tensor:
    """Realign one block in place on the resident msa_d / counts_d.

    rows int64 [B] row ids; lengths int32 [B] their base counts; lpad
    the block's length bucket. Returns int32 [B*maxf + B + 1]: the
    first maxf inserts of each row (y << 2 | base), each row's insert
    count, and the block's column-path drift (max over chunks of
    way[end] - way[start])."""
    cpad = msa_d.shape[1]
    dev = msa_d.device
    bh = bandwidth // 2
    rows_old = msa_d.index_select(0, rows)
    seqs, ways, last_way = compact_block(rows_old, lengths, lpad)
    # staircase window starts (constant per chunk) and the drift, which
    # the host checks against this block's slack when it reads `out`
    nc = -(-lpad // chunk)
    starts = torch.arange(nc, device=dev) * chunk
    ends = (starts + chunk - 1).clamp(max=lpad - 1)
    drift = (ways[:, ends] - ways[:, starts]).max()
    anf_full = sr.staircase_anf(ways, bandwidth, chunk)
    entry_bound = (last_way - bh).clamp(min=-1)
    codes, fband, fanf = cr.staircase_fill(
        counts_d, rows_old, seqs, ways, lengths, ncols,
        bandwidth=bandwidth, chunk=chunk, widen=widen)
    new_rows, _best, iy, ib, inn = cb.entry_and_backtrack(
        codes, fband, fanf, seqs, anf_full, entry_bound, lengths, ncols,
        cpad=cpad, bandwidth=bandwidth + widen * chunk, chunk=chunk)
    apply_rows(msa_d, counts_d, rows, rows_old, new_rows)
    iyb = (iy[:, :maxf] << 2) | ib[:, :maxf].to(torch.int32)
    return torch.cat([iyb.reshape(-1), inn.to(torch.int32),
                      drift.reshape(1).to(torch.int32)])


class DeviceResidentRealigner(BatchedRealigner):
    """The realign engine with the MSA resident on `device` (staircase
    band, kernels A and B; the exact band's blocks through kernels F and
    G on a CUDA device; block_rows > 1). The anneal hands block sizes
    below RESIDENT_MIN_BS to the tail's engine (`tail_kernel`): on a
    CUDA device the non-resident exact engine through kernels F and G
    (block 1 too: the serial sweep over a column store on the card), on
    the CPU the host native engine."""

    # below this block size the anneal continues on the non-resident
    # engine (the JAX package's threshold and its variable,
    # RR_RESIDENT_MIN_BS, read at class definition: where the engine
    # switches is part of the trajectory, since the two engines splice
    # and drop columns at different points of a sweep)
    RESIDENT_MIN_BS = int(os.environ.get("RR_RESIDENT_MIN_BS", "32"))
    # blocks realigned through the exact band and their seconds (host
    # clock, to the read of their inserts), by route: "cuda", kernels F
    # and G in place on a CUDA device; "native", the host native engine
    # (an engine on the CPU); "torch", the torch exact band on the CPU
    # (when the host library cannot be built). Seconds in resident
    # sweeps (to their last device sync), and one record a sweep:
    # {"s", "exact_blocks", "exact_block_s"}, for reports
    ROUTES = ("cuda", "native", "torch")
    exact_blocks_run = dict.fromkeys(ROUTES, 0)
    exact_block_s = dict.fromkeys(ROUTES, 0.0)
    resident_sweep_s = 0.0
    sweep_log: list = []
    # each best-MSA write downloads the whole MSA: realign_batched
    # writes at most every RR_BEST_WRITE_S seconds
    SNAPSHOT_COSTLY = True

    def __init__(self, msa: np.ndarray, bandwidth: int = 1000,
                 block_rows: int = 64, chunk: int = 256,
                 device: str | torch.device = "cuda", widen_state=None):
        if block_rows < 2:
            raise ValueError("the resident engine needs block_rows > 1")
        self._configure(bandwidth=bandwidth, block_rows=block_rows,
                        mode="exact", chunk=chunk, kernel="native",
                        mesh=None, device=device)
        # wide bands run at chunk 128 (the JAX engine's choice; any
        # chunk whose slack covers the drift gives the same result)
        self.chunk = min(chunk, 128) if bandwidth >= 768 else chunk
        self.device = resolve_device(device)
        msa = np.ascontiguousarray(msa, dtype=np.int8)
        self._nrows, self._ncols = msa.shape
        # the set-up's upload, [R, C]; EntAlGapper's drop (or the first
        # sweep) lays it out in the [R, CPAD] buffer
        with trace.span("resident.upload"):
            self._msa_d, self._counts_d, lengths_d = upload_msa(
                msa, self.device)
            self._lengths_all = lengths_d.cpu().numpy()
            self.counts = self._fetch_counts_host()
        self._cpad = None
        self._len_order = np.argsort(-self._lengths_all, kind="stable")
        if self.device.type == "cuda":
            # its exact blocks run on kernels F and G: refuse a band
            # whose longest row's codes do not fit the memory budget
            ce.rows_within(device_memory_budget(self.device),
                           max(1, int(self._lengths_all.max())),
                           bandwidth)
        self._widen = DEFAULT_WIDEN
        # the widest ladder rung whose window fits kernel A (0: none)
        self._w_fit = max((v for v in BatchedRealigner.WIDEN_LADDER
                           if bandwidth + v * self.chunk <= cr.MAX_W2),
                          default=0)
        self._maxf = MAX_INSERTS_FETCH
        self._overflow_events = 0         # insert-fetch overflows seen
        self._warned_no_library = False   # exact blocks without the library
        self._block_widen = None          # per-block adaptive slack
        self._widen_src_bs = None         # block size it is laid out for
        self._widen_state = widen_state   # (src_bs, widen[], exact[])
        #                                   from a checkpoint/respawn,
        #                                   adopted at the first layout
        self._ord_bs = None
        self._exact_blocks: set = set()   # block ids on the exact path

    # ------------------------------------------------ device lifecycle

    @property
    def msa(self) -> np.ndarray:
        """The MSA, downloaded from the device (a whole-MSA copy)."""
        return self._fetch_msa_host()

    def bases(self) -> int:
        return int(self._lengths_all.sum(dtype=np.int64))

    def _lay_out(self, keep: torch.Tensor | None = None) -> None:
        """Keep the columns `keep` (int64 ids on the device; None: every
        column) of the resident MSA and histogram, as one gather a row
        chunk. From the set-up's upload into the [R, CPAD] buffer sized
        from the width kept; once laid out, in place. Columns past the
        width hold ' ' and zero counts."""
        c, r = self._ncols, self._nrows
        dev = self.device
        if self._cpad is None:
            if keep is None:
                keep = torch.arange(c, device=dev)
            n = len(keep)
            # early sweeps insert many columns before the sweep-end drop
            # reclaims them: size the capacity for that, with in-place
            # growth (_flush_device) as the backstop
            cpad = -(-(n + max(32768, n // 3)) // 1024) * 1024
            msa_d = torch.full((r, cpad), 5, dtype=torch.int8, device=dev)
            counts_d = torch.zeros((cpad, 6), dtype=torch.int32, device=dev)
        elif keep is None or len(keep) == c:
            return
        else:
            n, cpad = len(keep), self._cpad
            msa_d, counts_d = self._msa_d, self._counts_d
        step = pass_rows(dev, c)
        for k0 in range(0, r, step):
            part = self._msa_d[k0:k0 + step].index_select(1, keep)
            msa_d[k0:k0 + step, :n] = part
            msa_d[k0:k0 + step, n:c] = 5
        kept = self._counts_d.index_select(0, keep)
        counts_d[:n] = kept
        counts_d[n:c] = 0
        self._msa_d, self._counts_d = msa_d, counts_d
        self._ncols, self._cpad = n, cpad

    def _ensure_order(self):
        """Block layout (each block's row ids and lengths, on host and
        on the device) and the per-block slack ladder. On a block-size
        change (the anneal) each new block inherits the max slack of
        the old blocks its rows came from, and exact-path flags
        propagate to every new block holding a flagged row."""
        bs = self.block_rows
        if self._ord_bs == bs:
            return
        r = self._nrows
        nb = -(-r // bs)
        if self._block_widen is None:
            if self._widen_state is not None:
                # adopt a learned ladder (checkpoint or respawn): a
                # resumed run dispatches at the learned slack
                src_bs, w, ex = self._widen_state
                self._widen_state = None
                self._block_widen = np.asarray(w, np.int32).copy()
                self._widen_src_bs = int(src_bs)
                self._exact_blocks = {int(b) for b in ex}
            else:
                # the first sweep runs everything at the default slack;
                # later blocks run one rung above their measured drift
                self._block_widen = np.full(nb, self._widen, np.int32)
                self._widen_src_bs = bs
        if self._widen_src_bs != bs or len(self._block_widen) != nb:
            old_bs = self._widen_src_bs
            per_row = np.repeat(self._block_widen, old_bs)[:r]
            if len(per_row) < r:
                per_row = np.concatenate(
                    [per_row,
                     np.full(r - len(per_row), self._widen, np.int32)])
            ex_row = np.zeros(r, bool)
            for b in self._exact_blocks:
                ex_row[b * old_bs:(b + 1) * old_bs] = True
            neww = np.full(nb, self._widen, np.int32)
            newex = set()
            for bid in range(nb):
                sl = slice(bid * bs, min((bid + 1) * bs, r))
                neww[bid] = per_row[sl].max()
                if ex_row[sl].any():
                    newex.add(bid)
            self._block_widen = neww
            self._exact_blocks = newex
            self._widen_src_bs = bs
        self._ord_host = self._len_order.astype(np.int64)
        self._len_host = self._lengths_all[self._ord_host]
        self._order_d = torch.from_numpy(self._ord_host).to(self.device)
        self._len_d = torch.from_numpy(self._len_host).to(self.device)
        self._ord_bs = bs

    def _fetch_msa_host(self) -> np.ndarray:
        return np.ascontiguousarray(
            self._msa_d[:, :self._ncols].cpu().numpy())

    def _fetch_counts_host(self) -> np.ndarray:
        return self._counts_d[:self._ncols].cpu().numpy().astype(np.int64)

    def ent_al_gapper(self) -> int:
        """EntAlGapper on the resident MSA (`ent_al_gapper_device`), its
        drop of the columns without bases as `_lay_out`'s gather.
        Returns the cells converted."""
        total = ent_al_gapper_device(self._msa_d, self._counts_d,
                                     self._ncols)
        self._lay_out(kept_columns(self._counts_d, self._ncols))
        self.counts = self._fetch_counts_host()
        return total

    def overall_pair(self):
        return overall_score_pair(self.counts)

    def best_snapshot(self) -> np.ndarray:
        return self._fetch_msa_host()

    def width(self) -> int:
        return self._ncols

    def validate(self):
        validate_counts(self._fetch_msa_host(), self._fetch_counts_host())

    def widen_state(self):
        """The learned drift ladder as a checkpointable tuple
        (src_block_rows, widen[], exact_block_ids[]), or None before the
        first layout."""
        if self._block_widen is None:
            return self._widen_state
        return (int(self._widen_src_bs), self._block_widen.copy(),
                tuple(sorted(self._exact_blocks)))

    def _tail_engine(self, msa, block_rows):
        """The anneal's tail below RESIDENT_MIN_BS: the non-resident
        exact engine, whose trajectory is the native engine's, on this
        engine's device (tail_kernel chooses its route)."""
        return BatchedRealigner(msa, bandwidth=self.bandwidth,
                                block_rows=block_rows, mode="exact",
                                kernel=tail_kernel(block_rows, self.device),
                                device=self.device)

    def respawn(self, msa, block_rows):
        if block_rows >= max(2, self.RESIDENT_MIN_BS):
            # this engine is done: free its device copy before the next
            # one uploads its own
            widen_state = self.widen_state()
            self._msa_d = self._counts_d = None
            return DeviceResidentRealigner(
                msa, bandwidth=self.bandwidth, block_rows=block_rows,
                chunk=self.chunk, device=self.device,
                widen_state=widen_state)
        # the anneal's tail (small blocks down to the serial block 1)
        return self._tail_engine(msa, block_rows)

    def shrink(self, block_rows):
        if block_rows >= max(2, self.RESIDENT_MIN_BS):
            self.block_rows = block_rows
            return self
        # the tail's engine takes the MSA on the host; this one is done
        msa = self._fetch_msa_host()
        self._msa_d = self._counts_d = None
        return self._tail_engine(msa, block_rows)

    # ------------------------------------------------------- the sweep

    def sweep(self) -> None:
        t0 = time.perf_counter_ns()
        cls = DeviceResidentRealigner
        n0, s0 = dict(cls.exact_blocks_run), dict(cls.exact_block_s)
        if self._cpad is None:            # no EntAlGapper ran (a respawn)
            self._lay_out()
        extra_exact: set = set()   # this sweep only: overflow redos
        for attempt in range(8):
            snap_m = self._msa_d.clone()  # sweep-start snapshot for
            snap_c = self._counts_d.clone()   # the redo
            snap_n = self._ncols
            if attempt:
                with trace.span("resident.redo"):
                    violations = self._try_sweep(extra_exact)
            else:
                violations = self._try_sweep(extra_exact)
            if not violations:
                t1 = time.perf_counter_ns()
                trace.record("resident.sweep", t0, t1)
                secs = (t1 - t0) / 1e9
                cls.resident_sweep_s += secs
                cls.sweep_log.append({
                    "s": secs,
                    "exact_blocks": {k: cls.exact_blocks_run[k] - n0[k]
                                     for k in cls.ROUTES},
                    "exact_block_s": {k: cls.exact_block_s[k] - s0[k]
                                      for k in cls.ROUTES}})
                return
            # restore and redo: drift violations that a ladder rung
            # within kernel A's window covers retry wider (_drain
            # already raised the slack); the rest go through the exact
            # band for good; insert-fetch overflows (-1) go exact for
            # this sweep only
            self._msa_d, self._counts_d = snap_m, snap_c
            self._ncols = snap_n
            lad_max = self._w_fit * self.chunk
            self._exact_blocks |= {
                bid for bid, dv in violations.items() if dv > lad_max}
            extra_exact |= {
                bid for bid, dv in violations.items() if dv < 0}
        raise RuntimeError("drift fallback did not converge")

    def _try_sweep(self, extra_exact=()) -> dict:
        """One sweep; returns {block id: drift} for blocks that violated
        their slack, or -1 for an insert-list overflow (empty when the
        sweep is good)."""
        r = self._nrows
        bs = self.block_rows
        pending: list = []
        fetches: list = []
        violations: dict = {}
        self._ensure_order()
        for bid in range(-(-r // bs)):
            sl = slice(bid * bs, min((bid + 1) * bs, r))
            rows = self._ord_host[sl]
            bl = self._len_host[sl]
            # the slack, capped at kernel A's widest window
            wd = min(int(self._block_widen[bid]), self._w_fit)
            if not wd:
                self._exact_blocks.add(bid)
            if bid in self._exact_blocks or bid in extra_exact:
                self._exact_block(rows, pending)
            else:
                with trace.span("resident.block"):
                    out = block_step(
                        self._msa_d, self._counts_d, self._order_d[sl],
                        self._len_d[sl], self._ncols,
                        bandwidth=self.bandwidth, chunk=self.chunk,
                        widen=wd, lpad=_bucket(max(1, int(bl.max()))),
                        maxf=self._maxf)
                fetches.append((bid, rows, out, wd))
            # read results three blocks behind the dispatch: the cap
            # check below then sees a pending count at most 3 blocks
            # stale, the same flush points as the JAX engine
            while len(fetches) > 3:
                self._drain(fetches.pop(0), pending, violations)
            # after a violation the sweep is redone anyway: keep going
            # to learn every violating block's drift, but stop splicing
            if not violations and len(pending) >= self._flush_cap:
                while fetches:
                    self._drain(fetches.pop(0), pending, violations)
                if violations:
                    continue
                # mid-sweep flushes drop empty columns too (bounds the
                # transient width of insert-heavy early sweeps)
                with trace.span("resident.flush"):
                    self._flush_device(pending, drop_empty=True)
                pending = []
        while fetches:
            self._drain(fetches.pop(0), pending, violations)
        if violations:
            return violations
        with trace.span("resident.flush"):
            self._flush_device(pending, drop_empty=True)
        return violations

    def _drain(self, item, pending, violations: dict) -> None:
        """Read one block's buffer into the pending insert list; record
        a violation; adapt the block's slack for its next dispatch to
        one ladder rung above the rung covering the measured drift,
        within kernel A's widest window (a drift beyond it sends the
        block exact, in `sweep`'s redo set)."""
        bid, rows, out, wd = item
        with trace.span("resident.wait"):
            out = out.cpu().numpy()
        bqn = len(rows)
        dv = int(out[-1])
        t = self.chunk
        lad = BatchedRealigner.WIDEN_LADDER
        i = next((j for j, v in enumerate(lad) if v * t >= dv), None)
        if i is not None:
            self._block_widen[bid] = min(lad[min(i + 1, len(lad) - 1)],
                                         self._w_fit)
        if dv > wd * t:
            violations[bid] = dv
            return
        maxf = self._maxf
        inn = out[bqn * maxf:bqn * maxf + bqn]
        if (inn > maxf).any():
            # a row's insert list overflowed the fetched window, so the
            # block's apply lost bases: redo the sweep with this block
            # on the exact band (its insert lists hold any count)
            self._overflow_events += 1
            violations[bid] = -1
            return
        iyb = out[:bqn * maxf].reshape(bqn, maxf)
        for b, k in enumerate(rows):
            for o in range(int(inn[b])):
                v = int(iyb[b, o])
                pending.append((v >> 2, int(k), o, v & 3))

    def _exact_block(self, rows, pending) -> None:
        """Exact-band realignment of a block whose drift exceeds any
        staircase slack (short fragments spread over wide spans), or
        whose insert list overflowed, written back in place; its inserts
        join `pending`. On a CUDA device through kernels F and G on the
        resident rows and histogram (`_exact_block_device`), whatever the
        host library's state: no host round trip and no fallback (in row
        groups within the memory budget; the engine refuses a band whose
        one row does not fit when it is made). On
        the CPU through the native host engine (the JAX package's route),
        or, when the host library cannot be built, the torch exact band
        (same math, both the reference recurrence; the first such block
        warns). Counted and timed by route."""
        t0 = time.perf_counter_ns()
        if self.device.type == "cuda":
            route = "cuda"
            iy, ib, inn = self._exact_block_device(rows)
        else:
            route, iy, ib, inn = self._exact_block_host(rows)
        for b, k in enumerate(rows):
            for o in range(int(inn[b])):
                pending.append((int(iy[b, o]), int(k), o, int(ib[b, o])))
        cls = DeviceResidentRealigner
        cls.exact_blocks_run[route] += 1
        t1 = time.perf_counter_ns()
        cls.exact_block_s[route] += (t1 - t0) / 1e9
        trace.record("resident.exact_block", t0, t1, {"route": route})

    def _exact_block_device(self, rows):
        """Kernels F and G on the block's resident rows (compacted on the
        device as block_step compacts them), the rows and histogram
        updated in place; returns the inserts (iy, ib, inn) on the
        host, each row's lists as long as its count."""
        dev = self.device
        lengths = self._lengths_all[np.asarray(rows)]
        # an upload from pageable memory waits for the queued blocks
        with trace.span("resident.wait"):
            rows_d = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
            len_d = torch.from_numpy(lengths).to(dev)
        rows_old = self._msa_d.index_select(0, rows_d)
        seqs, ways, last_way = compact_block(
            rows_old, len_d, max(1, int(lengths.max())))
        bh = self.bandwidth // 2
        new_rows, _best, iy, ib, inn = exact_block_dp(
            self._counts_d, rows_old, seqs, ways, len_d,
            (ways - bh).clamp(min=0), (last_way - bh).clamp(min=-1),
            self._ncols, bandwidth=self.bandwidth,
            budget=device_memory_budget(dev))
        apply_rows(self._msa_d, self._counts_d, rows_d, rows_old, new_rows)
        with trace.span("resident.wait"):
            inn = inn.cpu().numpy()
            k = max(1, int(inn.max()))
            return iy[:, :k].cpu().numpy(), ib[:, :k].cpu().numpy(), inn

    def _exact_block_host(self, rows):
        """The block of an engine on the CPU: the native engine (or the
        torch exact band without the host library) on its rows and
        histogram, the rows written back. Returns (route, iy, ib,
        inn)."""
        try:
            nat = _native()
        except NativeBuildError as e:
            nat = None
            if not self._warned_no_library:
                self._warned_no_library = True
                warnings.warn(
                    "exact blocks on the CPU run through the torch exact "
                    f"band (far slower than the host library): {e}",
                    RuntimeWarning,
                    stacklevel=3)
        c = self._ncols
        rows_d = torch.from_numpy(np.asarray(rows, np.int64)).to(
            self.device)
        rows_old_d = self._msa_d.index_select(0, rows_d)
        rows_host = np.ascontiguousarray(rows_old_d[:, :c].cpu().numpy())
        counts = self._counts_d[:c].cpu().numpy()
        seqs, ways, lengths = compact_rows(rows_host)
        if nat is not None:
            route = "native"
            new_rows, _best, iy, ib, inn = realign_block_native(
                nat, counts, rows_host, seqs, ways, lengths, self.bandwidth)
        else:
            route = "torch"
            new_rows, iy, ib, inn = self._exact_block_torch(
                counts, rows_host, seqs, ways, lengths)
        nr = torch.full((len(rows), self._cpad), 5, dtype=torch.int8,
                        device=self.device)
        nr[:, :c] = torch.from_numpy(new_rows).to(self.device)
        apply_rows(self._msa_d, self._counts_d, rows_d, rows_old_d, nr)
        return route, iy, ib, inn

    def _exact_block_torch(self, counts, rows_host, seqs, ways, lengths):
        """The torch exact band (ops/banded_realign) on the CPU, in
        sub-blocks whose unpacked [B, L, W] codes stay inside the memory
        budget; its insert capacity is MAX_INSERTS a row."""
        bs, c = rows_host.shape
        dev = self.device
        sub = max(1, min(bs, int(device_memory_budget(dev) // max(
            1, 2 * seqs.shape[1] * self.bandwidth))))
        counts_d = torch.from_numpy(counts).to(dev)
        outs = []
        for s0 in range(0, bs, sub):
            sl = slice(s0, s0 + sub)
            anf_full, entry_bound = band_starts(
                ways[sl], lengths[sl], self.bandwidth, self.chunk, False)
            new_rows, _best, iy, ib, inn = block_dp(
                counts_d, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in (rows_host[sl], seqs[sl], ways[sl],
                                      lengths[sl], anf_full, entry_bound)),
                c, bandwidth=self.bandwidth, chunk=self.chunk, widen=1,
                staircase=False, kernel="torch")
            outs.append([t.cpu().numpy() for t in (new_rows, iy, ib, inn)])
        new_rows, iy, ib, inn = (np.concatenate([o[i] for o in outs])
                                 for i in range(4))
        _check_inserts(inn, iy.shape[1])
        return new_rows, iy, ib, inn

    def _flush_device(self, pending, drop_empty: bool) -> None:
        """Sweep-end (or cap-triggered) splice plus optional empty-column
        drop, as one device gather; host mirrors updated."""
        with trace.span("resident.wait"):
            counts_now = self._fetch_counts_host()
        c = self._ncols
        n = len(pending)
        keep = None
        if drop_empty:
            keep = counts_now[:, 0:4].sum(axis=1) > 0
            if keep.all() and n == 0:
                self.counts = counts_now
                return
        elif n == 0:
            self.counts = counts_now
            return
        # reference order at one gap: rows in sweep order, reverse
        # discovery within a row
        pending.sort(key=lambda t: (t[0], t[1], -t[2]))
        ins_gap = np.array([g for g, k, o, b in pending], np.int64)
        ins_row = np.array([k for g, k, o, b in pending], np.int64)
        ins_base = np.array([b for g, k, o, b in pending], np.int8)
        # new logical order: np.insert semantics over the kept columns
        # (inserted columns are never empty, so splice-then-drop equals
        # drop-then-splice); the j-th insert lands at the count of kept
        # columns before its position, plus j
        keep_idx = (np.flatnonzero(keep) if keep is not None
                    else np.arange(c, dtype=np.int64))
        pos_kept = np.searchsorted(keep_idx, ins_gap + 1, side="left")
        c_new = len(keep_idx) + n
        dev = self.device
        if c_new > self._cpad:
            # grow the capacity in place
            grow = -(-(c_new + max(16384, c_new // 8)) // 1024) * 1024
            r = self._msa_d.shape[0]
            self._msa_d = torch.cat(
                [self._msa_d,
                 torch.full((r, grow - self._cpad), 5, dtype=torch.int8,
                            device=dev)], dim=1)
            self._counts_d = torch.cat(
                [self._counts_d,
                 torch.zeros((grow - self._cpad, 6), dtype=torch.int32,
                             device=dev)])
            self._cpad = grow
        newpos = pos_kept + np.arange(n, dtype=np.int64)
        # gmap[j] = source column of new column j; columns past c_new
        # copy the (padding) last capacity column
        gmap = np.full(self._cpad, self._cpad - 1, np.int64)
        kept_mask = np.ones(c_new, bool)
        kept_mask[newpos] = False
        gmap[:c_new][kept_mask] = keep_idx
        gmap_d = torch.from_numpy(gmap).to(dev)
        msa2 = self._msa_d.index_select(1, gmap_d)
        counts2 = self._counts_d.index_select(0, gmap_d)
        if n:
            # inserted columns from the PRE-splice neighbours: 5 where
            # either neighbour is 5 (or the gap is the last column),
            # else 4; the owner row's cell gets its base
            gap_d = torch.from_numpy(ins_gap).to(dev)
            prv = self._msa_d.index_select(1, gap_d)
            nxt = self._msa_d.index_select(
                1, (gap_d + 1).clamp(max=self._cpad - 1))
            col = torch.where((prv == 5) | (nxt == 5)
                              | (gap_d == c - 1)[None, :], 5, 4).to(
                torch.int8)
            col[torch.from_numpy(ins_row).to(dev),
                torch.arange(n, device=dev)] = torch.from_numpy(
                    ins_base).to(dev)
            newpos_d = torch.from_numpy(newpos).to(dev)
            msa2.index_copy_(1, newpos_d, col)
            counts2.index_copy_(0, newpos_d, _hist(col))
        self._msa_d, self._counts_d = msa2, counts2
        self._ncols = c_new
        with trace.span("resident.wait"):
            self.counts = self._fetch_counts_host()
