"""The plain reference of the MaxCorrs scan, for sampled columns.

MaxCorrelation.c:744-908 as the port's host scan defines it
(`compute_maxcorrs`, fast significance): for every (column, symbol)
group, the largest significance over its partner groups. A seed column
i pairs with every column j >= i + gap, in ascending order, until the
first j whose shared coverage with i falls below mincov (the coverage
break); a pair counts on both sides, so column i's value also takes the
pairs in which it is the partner of an earlier seed that had not broken
before reaching it. Seeds need a group size in (mincov // 4, rows) and
a column whose bases are the majority of its coverage; partners the
size alone. Every count is an exact int8 product (`torch._int_mm` on a
card, float32 sums on the CPU, exact below 2**24); the significance is
float64 (`ref/hypergeom.py`). Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import hypergeom as hg


def _pad8(t, rows_min=8):
    """Zero rows up to a multiple of 8 (at least rows_min); K is a
    multiple of 8 already (the rows are padded once)."""
    m = t.shape[0]
    mp = max(rows_min, -(-m // 8) * 8)
    return t if mp == m else torch.nn.functional.pad(t, (0, 0, 0, mp - m))


def _mm(a, b):
    """a @ b.T exactly: int8 a [M, K], b [N, K] -> int32 [M, N]."""
    m, n = a.shape[0], b.shape[0]
    if a.device.type == "cuda":
        return torch._int_mm(_pad8(a, 32), _pad8(b).t())[:m, :n]
    return (a.float() @ b.float().t()).int()


def _row_sums(m, chunk: int = 1 << 15):
    """int64 row sums of an int8 matrix, a block of rows at a time."""
    return torch.cat([m[k:k + chunk].sum(dim=1, dtype=torch.int64)
                      for k in range(0, m.shape[0], chunk)])


class MaxCorrRef:
    def __init__(self, msa: np.ndarray, mincov: int, gap: int, device):
        r, c = msa.shape
        self.r, self.c, self.mincov, self.gap = r, c, mincov, gap
        # rows padded with coverage gaps to a multiple of 8 (the products'
        # depth): they add to no count
        # and columns to a multiple of 8 with uncovered ones: they hold no
        # group, and a seed meets them only past its last real partner
        rp, cp = -(-r // 8) * 8, -(-c // 8) * 8
        m = torch.full((rp, cp), 5, dtype=torch.int8, device=device)
        m[:r, :c] = torch.from_numpy(np.ascontiguousarray(msa, np.int8)).to(
            device)
        m = m.t().contiguous()                                   # [Cp, Rp]
        self.cov = (m < 5).to(torch.int8)
        self.groups = torch.empty((cp, 5, rp), dtype=torch.int8,
                                  device=device)
        for s in range(5):
            self.groups[:, s] = m == s
        self.groups = self.groups.view(cp * 5, rp)
        del m
        sizes = _row_sums(self.groups).view(cp, 5)[:c]
        covcount = _row_sums(self.cov)[:c]
        size_ok = (sizes > mincov // 4) & (sizes < r)
        self.sizes = sizes.cpu().numpy()
        self.partner_ok = size_ok.cpu().numpy()
        self.seed_ok = (size_ok & (sizes[:, 0:4].sum(dim=1)
                                   > covcount // 2)[:, None]).cpu().numpy()
        self.brk = self._breaks()

    def _breaks(self, chunk: int = 4096) -> np.ndarray:
        """Per seed column, its first partner column j >= i + gap whose
        shared coverage is below mincov (c where none is)."""
        c = self.c
        out = np.full(c, c, np.int64)
        jj = torch.arange(self.cov.shape[0], device=self.cov.device)
        for i0 in range(0, c, chunk):
            shared = _mm(self.cov[i0:min(c, i0 + chunk)], self.cov)
            ii = torch.arange(i0, i0 + shared.shape[0],
                              device=shared.device)[:, None]
            fail = (jj[None, :] >= ii + self.gap) & (shared < self.mincov)
            first = torch.where(fail.any(dim=1), fail.int().argmax(dim=1),
                                c).clamp(max=c)
            out[i0:i0 + shared.shape[0]] = first.cpu().numpy()
            del shared, fail
        return out

    def column(self, i: int) -> np.ndarray:
        """The five maxima of column i, float64 [5]."""
        c, gap = self.c, self.gap
        gi = self.groups[i * 5:(i + 1) * 5]                      # [5, R]
        ci = self.cov[i:i + 1]                                   # [1, R]
        def mm(a, b):
            return _mm(a, b).cpu().numpy().astype(np.int64)
        s = mm(gi, self.groups)[:, :c * 5].reshape(5, c, 5)     # (k, j, kk)
        g1 = mm(gi, self.cov)[:, :c]                            # (k, j)
        g2 = mm(ci, self.groups)[0, :c * 5].reshape(c, 5)       # (j, kk)
        cv = mm(ci, self.cov)[0, :c]                            # (j)
        # the same sums with column i the partner of seed j
        g1p = mm(self.groups, ci)[:c * 5, 0].reshape(c, 5)      # (j, kk)
        g2p = mm(self.cov, gi)[:c]                              # (j, k)
        j = np.arange(c)
        as_seed = (j >= i + gap) & (j < self.brk[i])
        as_partner = (j <= i - gap) & (self.brk >= i + 1)
        best = np.zeros(5)
        for k in range(5):
            zs = []
            if self.seed_ok[i, k]:
                jj, kk = np.nonzero(as_seed[:, None] & self.partner_ok)
                zs.append(hg.positive_significance_fast(
                    s[k, jj, kk], g1[k, jj], g2[jj, kk], cv[jj],
                    self.sizes[i, k], self.sizes[jj, kk]))
            if self.partner_ok[i, k]:
                jj, kk = np.nonzero(as_partner[:, None] & self.seed_ok)
                zs.append(hg.positive_significance_fast(
                    s[k, jj, kk], g1p[jj, kk], g2p[jj, k], cv[jj],
                    self.sizes[jj, kk], self.sizes[i, k]))
            best[k] = max([0.0] + [float(z.max()) for z in zs if z.size])
        return best
