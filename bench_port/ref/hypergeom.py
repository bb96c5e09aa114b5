"""The hypergeometric significance of the MaxCorrs reference, float64.

A frozen copy of the port's `ops/hypergeom.py` (itself the JAX
package's host arithmetic: log-space hypergeometric tails, the same
formulation as the reference's GSL calls, MaxCorrelation.c:396-434),
cut to what `positive_significance_fast` needs, so that the yardstick
cannot move with the program.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln

LOG10 = np.log(10.0)

# gammaln(i + 1) for integer i — every argument in this module is a
# small non-negative integer (counts bounded by the MSA row count), so
# three table gathers replace three transcendental evaluations, with
# bit-identical values (same gammaln, same inputs). Grown on demand.
_GLN = gammaln(np.arange(4096, dtype=np.float64) + 1.0)


def _gln_int(x):
    """gammaln(x + 1) via table for non-negative integer-valued x."""
    global _GLN
    xi = np.asarray(x).astype(np.int64)
    hi = int(xi.max(initial=0))
    if hi >= _GLN.size:
        _GLN = gammaln(np.arange(hi + 1024, dtype=np.float64) + 1.0)
    return _GLN[xi]


def _log_binom(n, k):
    return _gln_int(n) - _gln_int(k) - _gln_int(np.asarray(n) - k)


def _hyg_logpmf(j, K, n, N):
    return (_log_binom(K, j) + _log_binom(N - K, n - j)
            - _log_binom(N, n))


def _series_logsum(lo, hi, K, n, N):
    """log of sum_{j=lo..hi} pmf(j), elementwise over arrays.

    Iterates with the pmf ratio recurrence; all inputs are float64
    arrays of equal shape. Elements with lo > hi yield -inf.
    """
    lo = np.asarray(lo, np.float64).copy()
    hi = np.asarray(hi, np.float64)
    K = np.asarray(K, np.float64)
    n = np.asarray(n, np.float64)
    N = np.asarray(N, np.float64)
    active = lo <= hi
    out_m = np.full(lo.shape, -np.inf)
    out_s = np.zeros(lo.shape)
    # compact to the active elements: in large batches (callers batch
    # whole seed chunks / pair blocks) elements converge at wildly
    # different term counts, and dense iteration would make every
    # element pay the batch maximum
    idx = np.nonzero(active.ravel())[0]
    lo, hi, K, n, N = (np.broadcast_to(a, active.shape).ravel()[idx]
                       for a in (lo, hi, K, n, N))
    l = _hyg_logpmf(lo, K, n, N)
    m = l.copy()                     # running max (log reference)
    s = np.ones(idx.shape)           # sum scaled by exp(-m)
    j = lo.copy()
    stopped = np.zeros(idx.shape, bool)
    it = 0
    max_iter = int(np.max(hi - lo)) + 1 if idx.size else 0
    while idx.size and it <= max_iter:
        it += 1
        nxt = j + 1
        done = (nxt > hi) | stopped
        if done.all():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            logr = (np.log(np.maximum(K - j, 0.0))
                    + np.log(np.maximum(n - j, 0.0))
                    - np.log(nxt)
                    - np.log(np.maximum(N - K - n + nxt, 1e-300)))
        l2 = l + logr
        upd = ~done
        bigger = upd & (l2 > m)
        s = np.where(bigger, s * np.exp(m - l2) + 1.0,
                     np.where(upd, s + np.exp(l2 - m), s))
        m = np.where(bigger, l2, m)
        l = np.where(upd, l2, l)
        j = np.where(upd, nxt, j)
        # per-element stop once remaining terms are decreasing and
        # negligible — results are independent of batch composition.
        # Stopped elements freeze in place (upd excludes them via
        # stopped) and are evicted in bulk once a quarter of the batch
        # has stopped, so the compaction gathers amortize.
        dec = l2 - m < -40.0
        with np.errstate(invalid="ignore"):
            shrinking = logr < -1e-12
        done = done | (dec & shrinking) | stopped
        nd = int(done.sum())
        if nd == done.size or 4 * nd >= done.size:
            fin = np.nonzero(done)[0]
            out_m[idx[fin]] = m[fin]
            out_s[idx[fin]] = s[fin]
            live = np.nonzero(~done)[0]
            idx = idx[live]
            if live.size == 0:
                break
            lo, hi, K, n, N, l, m, s, j = (
                a[live] for a in (lo, hi, K, n, N, l, m, s, j))
            stopped = np.zeros(live.size, bool)
        else:
            stopped = done
    if idx.size:
        out_m[idx] = m
        out_s[idx] = s
    with np.errstate(divide="ignore", invalid="ignore"):
        return (out_m + np.log(out_s)).reshape(active.shape)


def hyp_q(k, n1, n2, t):
    """gsl_cdf_hypergeometric_Q(k; n1, n2, t) = P[X > k], X drawn t from
    n1 successes + n2 failures. Vectorized float64."""
    k = np.asarray(k, np.float64)
    n1 = np.asarray(n1, np.float64)
    n2 = np.asarray(n2, np.float64)
    t = np.asarray(t, np.float64)
    k, n1, n2, t = np.broadcast_arrays(k, n1, n2, t)
    kmin = np.maximum(t - n2, 0.0)
    kmax = np.minimum(n1, t)
    lo = k + 1.0
    out = np.zeros(k.shape, np.float64)
    full = lo <= kmin
    some = (~full) & (lo <= kmax)
    out[full] = 1.0
    if some.any():
        ls = _series_logsum(lo[some], kmax[some], n1[some] + 0.0,
                            t[some], n1[some] + n2[some])
        out[some] = np.minimum(np.exp(ls), 1.0)
    return out


# ------------------------------------------------------- reference wrappers

def positive_cum_hyp_geo_log(schnitt, gr1, gr2, cov):
    """MaxCorrelation.c:413-419: -log10 Q(schnitt-1; gr2, cov-gr2, gr1),
    capped at 99. Vectorized."""
    q = hyp_q(np.asarray(schnitt) - 1, gr2,
              np.asarray(cov) - np.asarray(gr2), gr1)
    with np.errstate(divide="ignore"):
        z = -np.log10(q)
    return np.where(np.isinf(z) | (z > 99.0), 99.0, z)


def f_beta(schnitt, size1, size2, beta=1.0):
    """MaxCorrelation.c:396-411 on raw group sizes."""
    schnitt = np.asarray(schnitt, np.float64)
    g1n2 = np.asarray(size1, np.float64) - schnitt
    g2n1 = np.asarray(size2, np.float64) - schnitt
    z = (1.0 + beta) * schnitt
    denom = (1 + beta * beta) * schnitt + beta * beta * g1n2 + g2n1
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(z < 0.0001, 0.0, z / denom)
    return r


def positive_significance(schnitt, gr1, gr2, cov, size1, size2,
                          cap_base=98.0):
    """PositiveSignificance (MaxCorrelation.c:421-434): 0 for empty
    gr1/gr2 or schnitt<1; cap Z>98 -> cap_base + F1 (Group_ variant
    uses cap_base=97.90, RepeatResolver.c:486)."""
    schnitt = np.asarray(schnitt)
    z = positive_cum_hyp_geo_log(schnitt, gr1, gr2, cov)
    capped = np.isinf(z) | (z > 98.0)
    z = np.where(capped, cap_base + f_beta(schnitt, size1, size2), z)
    zero = (np.asarray(gr1) == 0) | (np.asarray(gr2) == 0) | (schnitt < 1)
    return np.where(zero, 0.0, z)


def positive_significance_fast(schnitt, gr1, gr2, cov, size1, size2,
                               cap_base=98.0):
    """Production fast path: mode-gated prefilter + exact evaluation.

    Pairs at/below the distribution mode get Z = 0 — their true Z is
    < ~0.5, far below any MaxCorrelation cutoff (>= 4), so significance
    DECISIONS are identical to positive_significance and the stored
    values of super-mode pairs are exact; only insignificant sub-mode
    values differ (stored as 0). The prefilter removes both ~90% of the
    evaluations and the slow-converging near-mode series.
    """
    s = np.atleast_1d(np.asarray(schnitt, np.float64))
    k = np.broadcast_to(np.asarray(gr2, np.float64), s.shape)
    n = np.broadcast_to(np.asarray(gr1, np.float64), s.shape)
    nn = np.broadcast_to(np.asarray(cov, np.float64), s.shape)
    s1 = np.broadcast_to(np.asarray(size1, np.float64), s.shape)
    s2 = np.broadcast_to(np.asarray(size2, np.float64), s.shape)
    mode = (n + 1.0) * (k + 1.0) / (nn + 2.0)
    relevant = (s > mode) & (s >= 1) & (n > 0) & (k > 0)
    out = np.zeros(s.shape, np.float64)
    if relevant.any():
        idx = np.nonzero(relevant)
        out[idx] = positive_significance(
            s[idx], n[idx], k[idx], nn[idx], s1[idx], s2[idx],
            cap_base=cap_base)
    return out
