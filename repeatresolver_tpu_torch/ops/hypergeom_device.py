"""Hypergeometric upper-tail significance in float32 on the device.

Counterpart of repeatresolver_tpu/ops/hypergeom_device.py: the MaxCorrs
device scan's significance (MaxCorrelation.c:421-434), evaluated for
every pair of a tile at once. The exact float64 series
(repeatresolver_tpu/ops/hypergeom.py) stays the host path.

Every lgamma argument is a count no larger than the MSA's row count, so
the log-factorials are precomputed on the host in float64 and stored as
a double-float (hi, lo) float32 pair; the device gathers them and sums
the 9 signed terms with compensated (TwoSum) accumulation, ~1e-6
absolute. Z is accurate to ~1e-5 for significant pairs; pairs at or
below the distribution's mode return exactly 0 (their true Z is below
~0.5, far under any MaxCorrs cutoff, MaxCorrelation.c:998).

The arithmetic is written out op by op in the JAX package's order and
must not be reassociated or compiled (TwoSum depends on it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG10E = 0.4342944819032518
# tail-loop steps between host reads of the stop flag (see the loop)
CHECK_EVERY = 8


def log_factorial_table(nmax: int):
    """Host-precomputed F[i] = lgamma(i+1) for i in 0..nmax as a
    double-float pair (hi, lo) of float32 numpy arrays."""
    v = np.array([math.lgamma(i + 1.0) for i in range(nmax + 1)],
                 np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _logp0_table(lf_hi, lf_lo, s, k, n, nn):
    """log pmf at s for HG(N=nn, K=k, n=n) via table gathers: the sum of
    9 signed F[.] terms in compensated double-float. Indices are clamped
    into [0, nmax] (torch indexing would raise where jnp.take clamps):
    negative ones occur only for masked pairs; ones above nmax would
    corrupt Z, so callers size the table to cover every count."""
    plus = (k, nn - k, n, nn - n)
    minus = (s, k - s, n - s, nn - k - n + s, nn)
    acc_hi = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    acc_lo = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    nmax = lf_hi.shape[0] - 1
    for idx_arr, sign in ((plus, 1.0), (minus, -1.0)):
        for idx in idx_arr:
            ii = idx.clamp(0, nmax).long()
            acc_hi, e = _two_sum(acc_hi, sign * lf_hi[ii])
            acc_lo = acc_lo + e + sign * lf_lo[ii]
    return acc_hi + acc_lo


def positive_significance_f32(schnitt, gr1, gr2, cov, size1, size2,
                              lf_hi, lf_lo, terms: int = 128):
    """Vectorized reference PositiveSignificance (MaxCorrelation.c:
    421-434) in float32, the 98 -> 98+F1 cap included.

    X ~ HG(N=cov, K=gr2 successes, n=gr1 draws); Z = -log10 P[X >=
    schnitt]. The count arguments are broadcastable integer tensors on
    one device. lf_hi/lf_lo: log_factorial_table(nmax) as tensors on
    that device, nmax >= max(cov) (the JAX package's fallback without a
    table, float32 lgamma, is not ported: no caller uses it)."""
    si = schnitt.to(torch.int32)
    ki = gr2.to(torch.int32)
    ni = gr1.to(torch.int32)
    nni = cov.to(torch.int32)
    s = si.float()
    k = ki.float()
    n = ni.float()
    nn = nni.float()
    mode = (n + 1.0) * (k + 1.0) / (nn + 2.0)
    relevant = (s > mode) & (s >= 1) & (n > 0) & (k > 0)

    logp0 = _logp0_table(lf_hi, lf_lo, si, ki, ni, nni)
    # pmf ratio r_j = p(s+j+1)/p(s+j); tail = 1 + sum_j prod_{i<=j} r_i,
    # as a running product (r_j = 0 is absorbing: the support bound).
    shp = torch.broadcast_shapes(s.shape, k.shape, n.shape, nn.shape)
    sb, kb, nb, nnb = (v.expand(shp) for v in (s, k, n, nn))
    # run starts at 0 for non-relevant pairs: below the mode the ratio
    # exceeds 1, the product overflows to inf and inf * 0 = NaN, which
    # would poison the batch-wide stop rule below
    run = torch.where(relevant.expand(shp), 1.0, 0.0).to(torch.float32)
    tail = torch.ones(shp, dtype=torch.float32, device=s.device)
    # The JAX while loop steps while (jj < terms) & (run.max() > 1e-8),
    # one rule for the whole batch. Here each step applies only while a
    # device-side flag says the rule holds, and the host reads the flag
    # every CHECK_EVERY steps. Once the rule fails, the frozen state keeps
    # failing it, so the extra steps change no bit, and the loop syncs
    # once per CHECK_EVERY steps instead of once per step.
    go = torch.ones((), dtype=torch.bool, device=s.device)
    jj = 0
    while run.numel() and jj < terms:
        for _ in range(min(CHECK_EVERY, terms - jj)):
            go = go & (run.max() > 1e-8)
            sjv = sb + float(jj)
            num = (kb - sjv) * (nb - sjv)
            den = (sjv + 1.0) * (nnb - kb - nb + sjv + 1.0)
            ratio = torch.where((num > 0) & (den > 0),
                                num / torch.clamp(den, min=1.0), 0.0)
            run = torch.where(go, run * ratio, run)
            tail = torch.where(go, tail + run, tail)
            jj += 1
        if not bool(go):
            break

    z = -(logp0 + torch.log(tail)) * LOG10E
    z = torch.where(torch.isfinite(z), torch.clamp(z, max=99.0), 99.0)
    f1num = 2.0 * s
    f1den = size1.float() + size2.float()
    f1 = torch.where(f1num < 0.0001, 0.0,
                     f1num / torch.clamp(f1den, min=1.0))
    z = torch.where(z > 98.0, 98.0 + f1, z)
    return torch.where(relevant, z, 0.0)
