"""Per-(column, symbol) maximum correlation significance (MaxCorrs).

Counterpart of repeatresolver_tpu/models/maxcorr.py. The host paths,
the exact numpy tile scan `compute_maxcorrs` and the banded-bitset C++
scan `compute_maxcorrs_native` (with `group_matrices` and `run`), are
copied from that module, same arithmetic; where the native library
cannot be built they raise instead of taking the numpy path. The
device scan is ported to torch.

`compute_maxcorrs_device` keeps the MSA's one-hot groups [C*5, R] as int8
on the device and runs the reference's threaded scan
(MaxCorrelation.c:744-908): each seed tile sweeps its partner tiles in
ascending order until the coverage break, GROUP partner tiles at a time.
A group is one `group_step`: one exact int8 product of the seed tile's
groups with the group's (ops/devmm.int_matmul_t), over the window of the
MSA's rows (sorted by their first covered column) that cover the seed
tile, from which every other count of the JAX package's four products is
a sum (ops/maxcorr_tile.py), then one call of kernel E (ops/cuda_maxcorr.py)
for the masks, the break across the group, the float32 significance of
every allowed pair (ops/hypergeom_device's arithmetic) and the per-group
maxima into both sides of the accumulator; on the CPU its plain version
(ops/maxcorr_tile.py). The coverage break stays on the device, as in the
JAX package's while_loop: the host reads the alive seeds once a group,
not after every pair. Semantics are compute_maxcorrs's; Z values are
float32 (~1e-5 where significant).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import MaxCorrConfig
from ..device import resolve_device
from ..ops import _build, cuda_maxcorr, maxcorr_tile
from ..ops import hypergeom as hg
from ..ops.devmm import int_matmul_t
from ..ops.hypergeom_device import log_factorial_table
from ..utils import io as rio
from ..utils import native as nat
from ..utils import trace
from ..utils.checkpoint import _atomic_write

__all__ = ["MaxCorrConfig", "MaxCorrScan", "compute_maxcorrs",
           "compute_maxcorrs_device", "compute_maxcorrs_native",
           "compute_maxcorrs_routed", "group_matrices", "run"]


# ---- copied from repeatresolver_tpu/models/maxcorr.py: the host scans

def group_matrices(msa: np.ndarray):
    """One-hot views: groups [C*5, R] float32, coverage [C, R] float32,
    sizes [C, 5], covcount [C]."""
    msa = np.asarray(msa)
    r, c = msa.shape
    groups = np.zeros((c, 5, r), np.float32)
    for s in range(5):
        groups[:, s, :] = (msa.T == s)
    coverage = (msa.T < 5).astype(np.float32)      # [C, R]
    sizes = groups.sum(axis=2).astype(np.int64)    # [C, 5]
    covcount = coverage.sum(axis=1).astype(np.int64)
    return groups.reshape(c * 5, r), coverage, sizes, covcount


_FORK_STATE: dict = {}


def _scan_seed_tiles(i0_list):
    """Worker: scan the given seed-tile rows, return a local maxcorrs.
    The reference's threaded variant stripes seed columns the same way
    and merges with elementwise max (MaxCorrelation.c:796, 881-891).
    BLAS is pinned to one thread per worker — the serial path already
    saturates cores through multithreaded matmuls, so workers must not
    multiply that."""
    s = _FORK_STATE
    try:
        from threadpoolctl import threadpool_limits
        with threadpool_limits(limits=1):
            return _tile_scan(i0_list, s["groups"], s["coverage"],
                              s["sizes_flat"], s["seed_ok"],
                              s["partner_ok"], s["c"], s["mincov"],
                              s["gap"], s["tile"], s["matmul"],
                              s["fast"])
    except ImportError:
        return _tile_scan(i0_list, s["groups"], s["coverage"],
                          s["sizes_flat"], s["seed_ok"],
                          s["partner_ok"], s["c"], s["mincov"],
                          s["gap"], s["tile"], s["matmul"], s["fast"])


def compute_maxcorrs(msa: np.ndarray, cfg: MaxCorrConfig,
                     tile: int = 256,
                     matmul=np.matmul, fast: bool = False,
                     threads: int = 0, native: str = "auto",
                     checkpoint_path: str | None = None) -> np.ndarray:
    """MaxCorrs for a full MSA -> float64 [C*5].

    fast=True uses the mode-gated fixed-term significance
    (hypergeom.positive_significance_fast): identical cutoff decisions,
    far cheaper; fast=False is the exact golden-parity path.
    threads>1 forks workers striped over seed tiles and merges with
    elementwise max — value-identical to the serial scan.
    native="auto" routes large fast scans through the banded-bitset
    C++ kernel (compute_maxcorrs_native, value-equal within fp
    tolerance); "never" forces the numpy path, "always" forces native."""
    msa = np.asarray(msa)
    if native != "never" and (native == "always" or
                              (fast and msa.size >= 1 << 22)):
        return compute_maxcorrs_native(
            msa, cfg, fast=fast, threads=max(threads, 1),
            checkpoint_path=checkpoint_path)
    r, c = msa.shape
    signumber = r
    mincov = cfg.mincov
    maxgroup = signumber
    groups, coverage, sizes, covcount = group_matrices(msa)
    sizes_flat = sizes.reshape(-1)

    baseno = sizes[:, 0:4].sum(axis=1)
    size_ok = (sizes_flat > mincov // 4) & (sizes_flat < maxgroup)
    seed_ok = size_ok.reshape(c, 5).copy()
    if cfg.majority_filter:
        seed_ok &= (baseno > covcount // 2)[:, None]
    partner_ok = size_ok.reshape(c, 5)
    gap = cfg.min_col_gap

    i0s = list(range(0, c, tile))
    if threads > 1 and len(i0s) > threads:
        import multiprocessing as mp
        _FORK_STATE.update(groups=groups, coverage=coverage,
                           sizes_flat=sizes_flat, seed_ok=seed_ok,
                           partner_ok=partner_ok, c=c, mincov=mincov,
                           gap=gap, tile=tile, matmul=matmul, fast=fast)
        try:
            ctx = mp.get_context("fork")
            with ctx.Pool(threads) as pool:
                parts = pool.map(_scan_seed_tiles,
                                 [i0s[w::threads]
                                  for w in range(threads)])
            return np.maximum.reduce(parts)
        finally:
            _FORK_STATE.clear()
    return _tile_scan(i0s, groups, coverage, sizes_flat, seed_ok,
                      partner_ok, c, mincov, gap, tile, matmul, fast)


def _tile_scan(i0_list, groups, coverage, sizes_flat, seed_ok,
               partner_ok, c, mincov, gap, tile, matmul,
               fast) -> np.ndarray:
    maxcorrs = np.zeros(c * 5, np.float64)
    for i0 in i0_list:
        i1 = min(c, i0 + tile)
        ti = i1 - i0
        seed_cols = seed_ok[i0:i1].any(axis=1)
        alive = seed_cols.copy()      # not yet hit the coverage break
        if not seed_cols.any():
            continue
        gi = groups[i0 * 5:i1 * 5]                  # [ti*5, R]
        ci = coverage[i0:i1]                        # [ti, R]
        for j0 in range(i0, c, tile):
            if not alive.any():
                break
            j1 = min(c, j0 + tile)
            tj = j1 - j0
            cj = coverage[j0:j1]
            # counts are small ints: f32 matmul results are exact;
            # full-tile astype copies are the single biggest cost.
            shared = matmul(ci, cj.T)                    # [ti, tj] f32
            ii = np.arange(i0, i1)[:, None]
            jj = np.arange(j0, j1)[None, :]
            valid = jj >= ii + gap
            fail = valid & (shared < mincov)
            cumfail = np.logical_or.accumulate(fail, axis=1)
            allowed = valid & alive[:, None] & ~cumfail
            alive &= ~cumfail[:, -1]
            if not allowed.any():
                continue
            gj = groups[j0 * 5:j1 * 5]
            schnitt = matmul(gi, gj.T)                   # [ti*5, tj*5]
            gr1 = matmul(gi, cj.T)                       # [ti*5, tj]
            gr2 = matmul(ci, gj.T)                       # [ti, tj*5]

            pair_ok = (allowed[:, None, :, None]
                       & seed_ok[i0:i1][:, :, None, None]
                       & partner_ok[j0:j1][None, None, :, :])
            pi, pk, pj, pkk = np.nonzero(pair_ok)
            if pi.size == 0:
                continue
            s_ = schnitt[pi * 5 + pk, pj * 5 + pkk].astype(np.int64)
            g1 = gr1[pi * 5 + pk, pj].astype(np.int64)
            g2 = gr2[pi, pj * 5 + pkk].astype(np.int64)
            cv = shared[pi, pj].astype(np.int64)
            sz1 = sizes_flat[(pi + i0) * 5 + pk]
            sz2 = sizes_flat[(pj + j0) * 5 + pkk]
            if fast:
                z = hg.positive_significance_fast(s_, g1, g2, cv, sz1,
                                                  sz2)
            else:
                z = hg.positive_significance(s_, g1, g2, cv, sz1, sz2)
            # dense-tile max reduction (ufunc.at scatter is too slow)
            zt = np.zeros((ti * 5, tj * 5), np.float32)
            zt[pi * 5 + pk, pj * 5 + pkk] = z
            np.maximum(maxcorrs[i0 * 5:i1 * 5], zt.max(axis=1),
                       out=maxcorrs[i0 * 5:i1 * 5])
            np.maximum(maxcorrs[j0 * 5:j1 * 5], zt.max(axis=0),
                       out=maxcorrs[j0 * 5:j1 * 5])
    return maxcorrs


def compute_maxcorrs_native(msa: np.ndarray, cfg: MaxCorrConfig,
                            fast: bool = True, threads: int = 4,
                            chunk: int = 4096,
                            checkpoint_path: str | None = None,
                            progress: bool = True) -> np.ndarray:
    """Banded-bitset C++ scan (csrc/host_ops.cpp maxcorr_scan).

    Same gate/break/value semantics as compute_maxcorrs (threaded-
    variant contract, MaxCorrelation.c:744-908): value-equal within fp
    tolerance (~1e-9; libm vs scipy lgamma). Seed columns are scanned
    in chunks; with checkpoint_path, the accumulated maxes and the
    next chunk index are written atomically after each chunk, and an
    interrupted scan resumes from the last completed chunk (the
    reference's own MaxCorrs-on-disk caching, MaxCorrelation.c:1014,
    made restartable mid-computation)."""
    msa = np.asarray(msa)
    r, c = msa.shape
    bits = nat.MaxCorrBitsets(msa)     # raises if the lib cannot build
    maxcorrs = np.zeros(c * 5, np.float64)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            if (int(z["c"]) == c and int(z["r"]) == r
                    and bool(z["fast"]) == fast):
                maxcorrs = z["maxcorrs"].copy()
                start = int(z["next"])
    t0 = time.perf_counter()
    for i0 in range(start, c, chunk):
        i1 = min(c, i0 + chunk)
        bits.scan(maxcorrs, i0, i1, cfg.mincov, cfg.min_col_gap,
                  r, cfg.majority_filter, fast, threads)
        if checkpoint_path:
            def w(f, i1=i1):
                np.savez(f, maxcorrs=maxcorrs, next=i1, c=c, r=r,
                         fast=fast)
            _atomic_write(checkpoint_path, w)
        if progress:
            dt = time.perf_counter() - t0
            done = i1 - start
            eta = dt / done * (c - i1) if done else 0.0
            print(f"  maxcorr scan {i1}/{c} cols "
                  f"({dt:.0f}s, eta {eta:.0f}s)", flush=True)
    return maxcorrs



# ---- the device scan

# partner tiles a seed tile queues between two host reads of its alive
# seeds, in one product and one call of kernel E (MaxCorrScan.group)
GROUP = 8
# the one-hot groups' rows (the products' depth) are padded to a multiple
# of this, and each seed tile's row window starts and ends on one, so that
# a product over the window starts on an aligned address
ROW_ALIGN = 128


def _row_sums(m: torch.Tensor, chunk: int = 1 << 14) -> torch.Tensor:
    """int32 row sums of an int8 matrix, in row chunks: a sum to int32
    widens its input, which for the paper-size one-hot groups (9 GB of
    int8) would take 36 GB at once."""
    return torch.cat([m[i:i + chunk].sum(dim=1, dtype=torch.int32)
                      for i in range(0, m.shape[0], chunk)])


def _covered_span(rows: torch.Tensor, chunk: int = 1 << 12):
    """(first, last) covered column (code < 5) of each MSA row of rows
    [R, C], int64; C and -1 for a row that covers none. In row chunks."""
    c = rows.shape[1]
    first, last = [], []
    for i in range(0, rows.shape[0], chunk):
        cov = rows[i:i + chunk] < 5
        some = cov.any(dim=1)
        cov = cov.to(torch.uint8)
        first.append(torch.where(some, cov.argmax(dim=1), c))
        last.append(torch.where(some, c - 1 - cov.flip(1).argmax(dim=1), -1))
    return torch.cat(first), torch.cat(last)


def _row_windows(first, last, tile, nt, rp):
    """[(lo, hi)] for each seed tile: a window of the rows, sorted by their
    first covered column (first, last: of the sorted rows), that holds
    every row covering one of the tile's columns, its ends rounded out to
    ROW_ALIGN within rp rows. A covering row has first < the tile's end
    (below hi) and last >= its start (at or past lo, the first row whose
    running maximum of last reaches the start)."""
    x0 = torch.arange(nt, device=first.device, dtype=torch.int64) * tile
    hi = torch.searchsorted(first, x0 + tile).tolist()
    lo = torch.searchsorted(torch.cummax(last, dim=0).values, x0).tolist()
    out = []
    for a, b in zip(lo, hi):
        a = min(a // ROW_ALIGN * ROW_ALIGN, rp - ROW_ALIGN)
        b = min(max(-(-b // ROW_ALIGN) * ROW_ALIGN, a + ROW_ALIGN), rp)
        out.append((a, b))
    return out


class MaxCorrScan:
    """The device state of one MSA's gated scan (one-hot groups, sizes,
    gates, the log-factorial table) and the scan itself.

    The MSA's rows are sorted by their first covered column (`row_order`:
    the sorted position's MSA row); every count is a sum over rows, so the
    order changes none. The rows covering a seed tile's columns then lie
    in one window of the sorted rows (`windows`), and a group's product
    runs over that window alone: the other rows are zero in every one of
    the seed tile's groups.

    Counters, over the scans of this object: `tile_pairs` scanned,
    `tile_pairs_needed` (those begun while a seed of the tile was alive:
    the pairs a host read after every pair would scan), `host_reads`
    (device-to-host reads), `seed_tiles` swept, `groups_queued` (group
    steps: calls of kernel E or its plain version) and
    `product_launches` (the int8 products, one a group)."""

    def __init__(self, msa: np.ndarray, cfg: MaxCorrConfig, tile: int,
                 device: torch.device, group: int = GROUP):
        msa = np.asarray(msa)
        r, c = msa.shape
        rows = torch.from_numpy(np.ascontiguousarray(msa, dtype=np.int8)).to(
            device)                                        # [R, C]
        # coverage (code < 5) is the sum of the five one-hot groups only
        # where no code is negative: the group pass derives every count
        # from the groups' product (ops/maxcorr_tile.py)
        low = int(rows.min()) if rows.numel() else 0
        if low < 0:
            raise ValueError(f"MaxCorrScan: the MSA holds a negative code "
                             f"({low}); codes are 0-4 (symbols and gap) "
                             "and 5 (uncovered)")
        # every hypergeometric count is <= r: the table must cover r, as
        # the gathers clamp out-of-range indices silently
        lf_hi, lf_lo = log_factorial_table(r)
        if lf_hi.shape[0] - 1 < r:
            raise AssertionError("log-factorial table undersized")
        self.lf = torch.from_numpy(np.stack([lf_hi, lf_lo], axis=1)).to(
            device)                                        # [r + 1, 2]
        self.r, self.c, self.t = r, c, tile
        self.group = group
        self.mincov = cfg.mincov
        self.gap = cfg.min_col_gap
        cpad = -(-c // tile) * tile
        self.nt = cpad // tile
        # rows padded to a multiple of ROW_ALIGN (the int8 product's
        # depth) with coverage gaps: zero groups, so no count changes
        rp = -(-r // ROW_ALIGN) * ROW_ALIGN
        first, last = _covered_span(rows)
        order = torch.argsort(first, stable=True)
        self.row_order = order.cpu().numpy()
        self.windows = _row_windows(first[order], last[order], tile,
                                    self.nt, rp)
        msa_d = torch.full((cpad, rp), 5, dtype=torch.int8, device=device)
        msa_d[:c, :r] = rows[order].t()
        del rows, first, last, order
        groups = torch.empty((cpad, 5, rp), dtype=torch.int8, device=device)
        for s in range(5):
            groups[:, s, :] = msa_d == s
        del msa_d
        self.groups = groups.view(cpad * 5, rp)            # [Cp*5, Rp]
        self.sizes = _row_sums(self.groups)
        by_col = self.sizes.view(cpad, 5)
        covcount = by_col.sum(dim=1)
        baseno = by_col[:, 0:4].sum(dim=1)
        size_ok = (self.sizes > self.mincov // 4) & (self.sizes < r)
        self.seed_ok = size_ok.view(cpad, 5)
        if cfg.majority_filter:
            self.seed_ok = self.seed_ok & (baseno > covcount // 2)[:, None]
        self.partner_ok = size_ok.view(cpad, 5)
        self.acc = torch.zeros(cpad * 5, dtype=torch.float32, device=device)
        self.tile_pairs = self.tile_pairs_needed = 0
        self.host_reads = self.seed_tiles = 0
        self.groups_queued = self.product_launches = 0

    def product(self, i0, j0, m):
        """The group's one int8 product (ops/devmm.int_matmul_t): the seed
        tile at column i0 (a multiple of the tile) against the m partner
        tiles from column j0, whose one-hot rows are one slice, over the
        seed tile's row window -> schnitt int32 [5t, m*5t]."""
        t = self.t
        lo, hi = self.windows[i0 // t]
        self.product_launches += 1
        return int_matmul_t(self.groups[i0 * 5:(i0 + t) * 5, lo:hi],
                            self.groups[j0 * 5:(j0 + m * t) * 5, lo:hi]
                            ).contiguous()

    def group_step(self, alive, alive_out, i0, j0):
        """The tile pairs of the seed tile at i0 with the m =
        alive_out.shape[0] partner tiles from j0 (MaxCorrelation.c:
        804-823): their product, then the group pass (ops/maxcorr_tile.py)
        into the accumulator and alive_out: kernel E on a CUDA device, the
        plain version on the CPU. Nothing is read back to the host."""
        m = alive_out.shape[0]
        ev = _build.launch_events("maxcorr_products")
        if ev:
            ev[0].record()
        schnitt = self.product(i0, j0, m)
        if ev:
            ev[1].record()
        args = (schnitt, alive, alive_out, self.seed_ok, self.partner_ok,
                self.sizes, self.lf, self.acc, i0, j0)
        kw = dict(gap=self.gap, ncols=self.c, mincov=self.mincov)
        if self.acc.device.type == "cuda":
            cuda_maxcorr.maxcorr_group(*args, **kw)
        else:
            maxcorr_tile.group_pass_plain(*args, **kw)
        self.groups_queued += 1
        self.tile_pairs += m

    def scan(self, i_tiles) -> torch.Tensor:
        """The gated scan of the seed tiles in i_tiles (entries >= the
        tile count are stride padding and scan nothing), max-merged into
        the accumulator, which is returned ([Cp*5] float32).

        A seed tile sweeps its partner tiles in ascending order until no
        seed is alive (the coverage break, MaxCorrelation.c:804-810). The
        host queues `group` tile pairs at a time as one group step, which
        writes the seeds alive after each tile into a row of a [group, t]
        buffer, and reads the buffer once a group; pairs queued past the
        break change nothing (no seed is alive there) and cost their share
        of the product. One more read skips the seed tiles without a
        seed."""
        t, nt = self.t, self.nt
        tiles = [int(k) for k in i_tiles if int(k) < nt]
        if not tiles:
            return self.acc
        with trace.span("maxcorr.wait"):
            has_seed = self.seed_ok.view(nt, t * 5).any(dim=1).cpu()
        self.host_reads += 1
        for k in tiles:
            if not has_seed[k]:
                continue
            self.seed_tiles += 1
            i0 = k * t
            alive = self.seed_ok[i0:i0 + t].any(dim=1)
            j = k
            while j < nt:
                m = min(self.group, nt - j)
                with trace.span("maxcorr.group"):
                    out = torch.empty((m, t), dtype=torch.bool,
                                      device=alive.device)
                    self.group_step(alive, out, i0, j * t)
                    with trace.span("maxcorr.wait"):
                        left = out.any(dim=1).tolist()
                self.host_reads += 1
                self.tile_pairs_needed += 1 + sum(left[:-1])
                if not left[-1]:
                    break
                alive = out[-1]
                j += m
        return self.acc

    def stats(self) -> dict:
        return dict(tile_pairs=self.tile_pairs,
                    tile_pairs_needed=self.tile_pairs_needed,
                    host_reads=self.host_reads, seed_tiles=self.seed_tiles,
                    groups_queued=self.groups_queued,
                    product_launches=self.product_launches,
                    group=self.group)


def compute_maxcorrs_device(msa: np.ndarray, cfg: MaxCorrConfig,
                            tile: int = 256, mesh=None,
                            device="cuda") -> np.ndarray:
    """MaxCorrs through the device scan on `device` -> float64 [C*5].
    `compute_maxcorrs_device.last_stats` holds the scan's counters
    (MaxCorrScan.stats) and its seconds, up to the result's copy to the
    host.

    mesh: a parallel/sharded.Mesh. The seed tiles are striped round-robin
    over its ranks (the reference's pthread seed stripes,
    MaxCorrelation.c:796), each rank scans its stripe on its own device,
    and the accumulators merge by an elementwise max (the thread merge,
    :881-891): every rank returns the whole result, bit-equal to the
    single scan's (a max is exact)."""
    msa = np.asarray(msa)
    t0 = time.perf_counter()
    with trace.span("maxcorr.call"):
        with trace.span("maxcorr.setup"):
            sc = MaxCorrScan(msa, cfg, tile, mesh.device if mesh is not None
                             else resolve_device(device))
        if mesh is None:
            acc = sc.scan(range(sc.nt))
        else:
            acc = mesh.all_reduce(
                sc.scan(range(mesh.rank, sc.nt, mesh.size)), "max")
        with trace.span("maxcorr.download"):
            out = acc[:msa.shape[1] * 5].cpu().numpy().astype(np.float64)
    compute_maxcorrs_device.calls += 1
    compute_maxcorrs_device.last_stats = dict(
        sc.stats(), seconds=time.perf_counter() - t0)
    return out


compute_maxcorrs_device.calls = 0
compute_maxcorrs_device.last_stats = {}


def compute_maxcorrs_routed(msa: np.ndarray, cfg: MaxCorrConfig, device,
                            threads: int,
                            checkpoint_path: str | None = None
                            ) -> np.ndarray:
    """The MaxCorrs stage of run_pipeline and of the paper driver, behind
    the JAX package's gate: the device scan on a CUDA device at >= 512
    rows and > 4M cells, where the rows make the pairwise products
    large; else the host fast path, which wins on small problems and on
    the CPU (identical significance decisions, exact values where
    significant; `threads` workers striped over seed tiles, with its
    checkpoint)."""
    rows, cols = msa.shape
    if (torch.device(device).type == "cuda" and rows >= 512
            and rows * cols > 4_000_000):
        return compute_maxcorrs_device(msa, cfg, device=device)
    return compute_maxcorrs(msa, cfg, fast=True, threads=threads,
                            checkpoint_path=checkpoint_path)


def run(msa_path: str, cfg: MaxCorrConfig, out_path: str | None = None,
        **kw) -> np.ndarray:
    """CLI-equivalent: MSA file in, MaxCorrsOf_<path> out."""
    msa = rio.read_msa(msa_path)
    mc = compute_maxcorrs(msa, cfg, **kw)
    if out_path is None:
        out_path = rio.maxcorrs_path(msa_path)
    rio.write_maxcorrs(out_path, mc)
    return mc
