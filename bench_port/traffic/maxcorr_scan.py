"""Traffic kind `maxcorr_scan`: the MaxCorrs device scan, scan after scan.

A scan is `compute_maxcorrs_device(msa, MaxCorrConfig(mincov, gap))`
over the cell's generated MSA at full depth: the int8 one-hot groups on
the card, one int8 product and one call of kernel E a group of tile
pairs, the coverage break read once a group. A scan's work is the MSA's
columns.

The check (after the window, the program's state freed): the last
scan's maxima of `sample` columns drawn from the seed (five symbols
each) against the reference's (`ref/maxcorr.py`, float64), as the
largest absolute gap; and every scan gave the same maxima.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from bench_port.gen.msa import make_cell_input
from bench_port.ref.maxcorr import MaxCorrRef
from bench_port.trace import span

# the largest gap between the program's float32 maxima and the
# reference's float64 ones (PERF.md §4 gives the readings it is set from)
DZ_LIMIT = 2e-3


def prepare(cfg: dict, wl: dict, seed: int, device):
    return MaxCorrScanCell(cfg, wl["params"], seed, device)


class MaxCorrScanCell:
    def __init__(self, cfg, params, seed, device):
        from repeatresolver_tpu_torch.config import MaxCorrConfig
        from repeatresolver_tpu_torch.ops import _build
        self.mc = MaxCorrConfig(mincov=int(cfg["maxcorr_mincov"]),
                                min_col_gap=int(cfg["maxcorr_min_col_gap"]))
        self.sample = int(params["sample"])
        self.seed, self.device = seed, device
        self.inp = make_cell_input(cfg, int(params["copies"]), seed)
        if device.type == "cuda":
            _build.prebuild(["maxcorr_tile"])
            _build.load("maxcorr_tile")
        # warm up on the window's own shape: one whole scan (a scan on a
        # slice left the first full scan of one run 13 s slower)
        self._scan(self.inp.msa)
        self.first = self.out = None
        self.stats = {}

    def _scan(self, msa):
        from repeatresolver_tpu_torch.models.maxcorr import \
            compute_maxcorrs_device
        with span("maxcorr.scan"):
            out = compute_maxcorrs_device(msa, self.mc, device=self.device)
        self.stats = dict(compute_maxcorrs_device.last_stats)
        return out

    def unit(self) -> int:
        self.out = self._scan(self.inp.msa)
        if self.first is None:
            self.first = self.out
        return self.inp.msa.shape[1]

    def check(self, control: bool):
        import torch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        msa = self.inp.msa
        c = msa.shape[1]
        cols = np.sort(np.random.default_rng([self.seed, 3]).choice(
            c, size=min(self.sample, c), replace=False))
        t0 = time.perf_counter()
        ref = MaxCorrRef(msa, self.mc.mincov, self.mc.min_col_gap,
                         self.device)
        t1 = time.perf_counter()
        want = np.stack([ref.column(int(i)) for i in cols])
        del ref
        print(f"maxcorr reference: breaks {t1 - t0:.1f} s, {len(cols)} "
              f"columns {time.perf_counter() - t1:.1f} s", file=sys.stderr)
        got = self.out.reshape(c, 5)[cols]
        if control:
            # the reference's maxima in bfloat16, the precision below E's
            got = torch.from_numpy(want).to(torch.bfloat16).double().numpy()
        return [("max_dz", float(np.abs(got - want).max()), DZ_LIMIT),
                ("scans_differ",
                 int(not np.array_equal(self.first, self.out)), 0)]
