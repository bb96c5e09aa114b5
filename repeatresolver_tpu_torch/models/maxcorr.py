"""Per-(column, symbol) maximum correlation significance (MaxCorrs).

Counterpart of repeatresolver_tpu/models/maxcorr.py. The host paths,
the exact numpy tile scan `compute_maxcorrs` and the banded-bitset C++
scan `compute_maxcorrs_native`, are the JAX module's (its top level
imports no jax) and are re-exported. This module ports the device scan.

`compute_maxcorrs_device` keeps the MSA's one-hot groups [C*5, R] and
coverage [C, R] as int8 on the device and runs the reference's threaded
scan (MaxCorrelation.c:744-908) as a host loop over seed tiles: each
seed tile sweeps its partner tiles in ascending order until the
coverage break, and each tile pair is one `tile_step`: three exact int8
products (ops/devmm.int_matmul_t), the float32 significance of every
pair of the tile (ops/hypergeom_device) and the per-group max into both
sides of the accumulator. Semantics are compute_maxcorrs's; Z values
are float32 (~1e-5 where significant).
"""
from __future__ import annotations

import numpy as np
import torch

from repeatresolver_tpu.config import MaxCorrConfig
from repeatresolver_tpu.models.maxcorr import (compute_maxcorrs,
                                               compute_maxcorrs_native,
                                               group_matrices, run)

from ..device import resolve_device
from ..ops.devmm import int_matmul_t
from ..ops.hypergeom_device import (log_factorial_table,
                                    positive_significance_f32)

__all__ = ["MaxCorrConfig", "MaxCorrScan", "compute_maxcorrs",
           "compute_maxcorrs_device", "compute_maxcorrs_native",
           "group_matrices", "run"]


def _row_sums(m: torch.Tensor, chunk: int = 1 << 14) -> torch.Tensor:
    """int32 row sums of an int8 matrix, in row chunks: a sum to int32
    widens its input, which for the paper-size one-hot groups (9 GB of
    int8) would take 36 GB at once."""
    return torch.cat([m[i:i + chunk].sum(dim=1, dtype=torch.int32)
                      for i in range(0, m.shape[0], chunk)])


class MaxCorrScan:
    """The device state of one MSA's gated scan (one-hot groups,
    coverage, sizes, gates, log-factorial tables) and the scan itself."""

    def __init__(self, msa: np.ndarray, cfg: MaxCorrConfig, tile: int,
                 device: torch.device):
        msa = np.asarray(msa)
        r, c = msa.shape
        # every hypergeometric count is <= r: the table must cover r, as
        # the gathers clamp out-of-range indices silently
        lf_hi, lf_lo = log_factorial_table(r)
        if lf_hi.shape[0] - 1 < r:
            raise AssertionError("log-factorial table undersized")
        self.lf_hi = torch.from_numpy(lf_hi).to(device)
        self.lf_lo = torch.from_numpy(lf_lo).to(device)
        self.r, self.c, self.t = r, c, tile
        self.mincov = cfg.mincov
        self.gap = cfg.min_col_gap
        cpad = -(-c // tile) * tile
        self.nt = cpad // tile
        # rows padded to a multiple of 8 (the int8 product's depth) with
        # coverage gaps: zero groups and coverage, so no count changes
        rp = -(-r // 8) * 8
        msa_d = torch.full((cpad, rp), 5, dtype=torch.int8, device=device)
        msa_d[:c, :r] = torch.from_numpy(
            np.ascontiguousarray(msa, dtype=np.int8)).to(device).t()
        groups = torch.empty((cpad, 5, rp), dtype=torch.int8, device=device)
        for s in range(5):
            groups[:, s, :] = msa_d == s
        self.groups = groups.view(cpad * 5, rp)            # [Cp*5, Rp]
        self.coverage = (msa_d < 5).to(torch.int8)         # [Cp, Rp]
        del msa_d
        self.sizes = _row_sums(self.groups)
        covcount = _row_sums(self.coverage)
        baseno = self.sizes.view(cpad, 5)[:, 0:4].sum(dim=1)
        size_ok = (self.sizes > self.mincov // 4) & (self.sizes < r)
        self.seed_ok = size_ok.view(cpad, 5)
        if cfg.majority_filter:
            self.seed_ok = self.seed_ok & (baseno > covcount // 2)[:, None]
        self.partner_ok = size_ok.view(cpad, 5)
        self.iota = torch.arange(tile, device=device)
        self.acc = torch.zeros(cpad * 5, dtype=torch.float32, device=device)
        self.tile_pairs = 0

    def tile_step(self, alive, i0, j0, gi, ci, sok, szi):
        """One tile pair (MaxCorrelation.c:804-823): pairs at jj >= ii +
        gap inside the MSA, cut at each seed's first partner whose shared
        coverage drops below mincov; Z of every allowed (group, group)
        pair; per-group max into both sides of the accumulator. Returns
        the seeds still alive after this partner tile."""
        t = self.t
        gj = self.groups[j0 * 5:(j0 + t) * 5]
        cj = self.coverage[j0:j0 + t]
        shared = int_matmul_t(ci, cj)                       # [t, t]
        ii = i0 + self.iota[:, None]
        jj = j0 + self.iota[None, :]
        valid = (jj >= ii + self.gap) & (jj < self.c)
        fail = valid & (shared < self.mincov)
        cumfail = torch.cumsum(fail.to(torch.int32), dim=1) > 0
        allowed = valid & alive[:, None] & ~cumfail
        alive_next = alive & ~cumfail[:, -1]

        schnitt = int_matmul_t(gi, gj)                      # [t5, t5]
        gr1 = int_matmul_t(gi, cj)                          # [t5, t]
        gr2 = int_matmul_t(ci, gj)                          # [t, t5]
        pok = self.partner_ok[j0:j0 + t]
        szj = self.sizes[j0 * 5:(j0 + t) * 5]
        pair_ok = (allowed[:, None, :, None] & sok[:, :, None, None]
                   & pok[None, None, :, :]).reshape(t * 5, t * 5)
        # pair (i*5+k, j*5+kk) reads gr1[i*5+k, j], gr2[i, j*5+kk] and
        # shared[i, j]
        g1 = gr1.repeat_interleave(5, dim=1)
        g2 = gr2.repeat_interleave(5, dim=0)
        cv = shared.repeat_interleave(5, dim=0).repeat_interleave(5, dim=1)
        z = positive_significance_f32(schnitt, g1, g2, cv, szi[:, None],
                                      szj[None, :], self.lf_hi, self.lf_lo)
        z = torch.where(pair_ok, z, 0.0)
        acc = self.acc
        acc[i0 * 5:(i0 + t) * 5] = torch.maximum(
            acc[i0 * 5:(i0 + t) * 5], z.max(dim=1).values)
        acc[j0 * 5:(j0 + t) * 5] = torch.maximum(
            acc[j0 * 5:(j0 + t) * 5], z.max(dim=0).values)
        self.tile_pairs += 1
        return alive_next

    def scan(self, i_tiles) -> torch.Tensor:
        """The gated scan of the seed tiles in i_tiles (entries >= the
        tile count are stride padding and scan nothing), max-merged into
        the accumulator, which is returned ([Cp*5] float32)."""
        t, nt = self.t, self.nt
        for k in i_tiles:
            k = int(k)
            if k >= nt:
                continue
            i0 = k * t
            sok = self.seed_ok[i0:i0 + t]
            alive = sok.any(dim=1)
            gi = self.groups[i0 * 5:(i0 + t) * 5]
            ci = self.coverage[i0:i0 + t]
            szi = self.sizes[i0 * 5:(i0 + t) * 5]
            j = k
            # one host read per tile pair: the coverage break
            while j < nt and bool(alive.any()):
                alive = self.tile_step(alive, i0, j * t, gi, ci, sok, szi)
                j += 1
        return self.acc


def compute_maxcorrs_device(msa: np.ndarray, cfg: MaxCorrConfig,
                            tile: int = 256, mesh=None,
                            device="cuda") -> np.ndarray:
    """MaxCorrs through the device scan on `device` -> float64 [C*5].

    mesh (the JAX package's seed-tile striping over a device mesh) waits
    for the port's parallel/ slice."""
    if mesh is not None:
        raise NotImplementedError("compute_maxcorrs_device(mesh=...) is "
                                  "not ported yet")
    msa = np.asarray(msa)
    sc = MaxCorrScan(msa, cfg, tile, resolve_device(device))
    acc = sc.scan(range(sc.nt))
    compute_maxcorrs_device.calls += 1
    return acc[:msa.shape[1] * 5].cpu().numpy().astype(np.float64)


compute_maxcorrs_device.calls = 0
