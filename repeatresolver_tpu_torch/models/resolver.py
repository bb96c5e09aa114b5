"""Windowed copy-group clustering (the reference RepeatResolver).

Counterpart of repeatresolver_tpu/models/resolver.py. The seven
functions that reach the exact resolver matmuls (group_refinement,
relative_vars, _grmatch_matrix, kmeans, kmeans_subdivision,
resolve_window, run) are ported here and route those products through
the port's ops/devmm on the caller's `device`; every other piece of
the clustering (window extraction, the DropOff / RelativeDropoff
subdivisions, the clique bookkeeping, the scalar significance and the
greedy clique, the cutoff helpers the product path leaves unused, the
flank-connection chain) is copied from that module, same arithmetic.

resolve_window's card route (the default on a CUDA device) keeps the
window's groups on the device (CardGroups) and runs there the two parts
that scale as thousands x thousands: group_refinement's candidate
statistics and cliques (_cliques_card) and every cluster's
relative_vars pair pass in one pass (_relative_vars_card, kernel H).
The float64 significance values still come from the host's own
functions (ops/hypergeom), evaluated once for each distinct argument
tuple the device found: they are elementwise, so a value looked up for
a tuple is the value the host route computes for it, and the
subdivisions equal the host route's byte for byte. SplitClock times a
window's parts (SPLIT_PARTS) on either route.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import ResolverConfig
from ..device import resolve_device
from ..ops import _build
from ..ops import cuda_resolver as cv
from ..ops import devmm
from ..ops import hypergeom as hg
from ..utils import io as rio
from ..utils import native
from ..utils import trace

__all__ = ["group_refinement", "kmeans", "kmeans_subdivision",
           "relative_vars", "resolve_window", "run"]


# resolve_window's parts, in the order a window runs them
SPLIT_PARTS = ("extract", "refine_products", "refine_candidates",
               "refine_significance", "refine_cliquer", "refine_tail",
               "dropoff", "reldrop", "relvars_gather", "relvars_product",
               "relvars_pairs", "kmeans")


class SplitClock:
    """Host seconds of a window's parts (SPLIT_PARTS). `lap(part)` books
    the time since the previous lap to `part`, and records it as the
    span `resolve.<part>` (utils/trace); on a CUDA device each lap first
    synchronises it, so a part holds its own device work. `counts`
    holds the card route's tallies (candidates, tuples evaluated on the
    host, pairs, launches, and kernel H's ms while ops/_build.
    kernel_events times launches)."""

    def __init__(self, device="cpu"):
        self.s = dict.fromkeys(SPLIT_PARTS, 0.0)
        self.counts: dict[str, int] = {}
        dev = torch.device(device)
        self._sync = dev if dev.type == "cuda" else None
        self._t = time.perf_counter_ns()

    def lap(self, part: str) -> None:
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        t = time.perf_counter_ns()
        self.s[part] += (t - self._t) / 1e9
        trace.record("resolve." + part, self._t, t)
        self._t = t

    def count(self, key: str, n) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


# ---- copied from repeatresolver_tpu/models/resolver.py: the host pieces
# of the clustering that reach no matrix product

@dataclass
class Window:
    signatures: np.ndarray        # int8 [n, w] rows with full coverage
    ausgelassen: np.ndarray       # int8 [realsigno] 1 kept / -1 dropped
    von: int
    bis: int                      # inclusive, clamped

    @property
    def signumber(self) -> int:
        return self.signatures.shape[0]

    @property
    def siglength(self) -> int:
        return self.signatures.shape[1]


def extract_window(msa: np.ndarray, von: int, bis: int) -> Window:
    """Einlesen: keep rows with a non-space at BOTH window ends."""
    c = msa.shape[1]
    bis = min(bis, c - 1)
    keep = (msa[:, von] != 5) & (msa[:, bis] != 5)
    ausgelassen = np.where(keep, 1, -1).astype(np.int8)
    return Window(np.ascontiguousarray(msa[keep, von:bis + 1]),
                  ausgelassen, von, bis)


@dataclass
class GroupData:
    """One-hot group/coverage matrices for a window."""
    groups: np.ndarray            # bool [w*5, n]
    coverage: np.ndarray          # bool [w, n]
    sizes: np.ndarray             # int64 [w*5]
    covcount: np.ndarray          # int64 [w]

    @classmethod
    def from_window(cls, win: Window) -> "GroupData":
        sig = win.signatures
        n, w = sig.shape
        groups = np.zeros((w, 5, n), bool)
        for s in range(5):
            groups[:, s, :] = (sig.T == s)
        groups = groups.reshape(w * 5, n)
        coverage = (sig.T < 5)
        return cls(groups, coverage,
                   groups.sum(axis=1).astype(np.int64),
                   coverage.sum(axis=1).astype(np.int64))


def group_positive_significance(g1: np.ndarray, g2: np.ndarray,
                                cov1: np.ndarray,
                                cov2: np.ndarray) -> float:
    """Group_PositiveSignificance (RepeatResolver.c:472-488), scalar."""
    schnitt = int(np.dot(g1, g2))
    cov = int(np.dot(cov1, cov2))
    gr1 = int(np.dot(g1, cov2))
    gr2 = int(np.dot(g2, cov1))
    if gr1 == 0 or gr2 == 0:
        return 0.0
    z = float(hg.positive_cum_hyp_geo_log(
        np.array([schnitt]), np.array([gr1]), np.array([gr2]),
        np.array([cov]))[0])
    if np.isinf(z) or z > 98.0:
        z = 97.90 + float(hg.f_beta(schnitt, g1.sum(), g2.sum()))
    return z


def cliquer(gd: GroupData, mincov: int, maxclique: int, greedy: float,
            seed: int) -> list[int]:
    """Greedy clique on the seed group (RepeatResolver.c:1179-1240)."""
    g_seed = gd.groups[seed].astype(np.float64)
    cov_seed = gd.coverage[seed // 5].astype(np.float64)
    gf = gd.groups.astype(np.float64)
    covf = gd.coverage.astype(np.float64)
    schnitt = gf @ g_seed                       # [w*5]
    gr1 = gf @ cov_seed                         # [w*5]
    gr2 = covf @ g_seed                         # [w]  (per column)
    cov = covf @ cov_seed                       # [w]
    cand = np.nonzero((schnitt > mincov // 4)
                      & (np.arange(len(schnitt)) != seed))[0]
    if cand.size == 0:
        return [seed] + [-1]
    s_ = schnitt[cand].astype(np.int64)
    g1 = gr1[cand].astype(np.int64)
    g2 = gr2[cand // 5].astype(np.int64)
    cv = cov[cand // 5].astype(np.int64)
    z = hg.positive_significance(
        s_, g1, g2, cv, gd.sizes[cand],
        np.full(cand.shape, gd.sizes[seed]), cap_base=97.90)

    # TheBestUpdater simulation over candidates in index order.
    best_scores = [0.0] * maxclique
    clique = [seed] + [0] * (maxclique - 1)
    for idx, zz in zip(cand, z):
        if zz <= greedy:
            continue
        if best_scores[maxclique - 1] >= zz:
            continue
        ii = maxclique - 1
        while best_scores[ii] < zz and ii > 0:
            ii -= 1
        ii += 1
        best_scores[ii + 1:maxclique] = best_scores[ii:maxclique - 1]
        clique[ii + 1:maxclique] = clique[ii:maxclique - 1]
        best_scores[ii] = zz
        clique[ii] = int(idx)
    best_scores[0] = 100.0
    clique = clique + [-1]
    j = maxclique - 1
    while best_scores[j] < greedy or clique[j] == clique[j - 1]:
        clique[j] = -1
        j -= 1
    return clique


def clique_len(clique: list[int]) -> int:
    """CliqueGroup's length scan: first negative entry (:982-989)."""
    for jj, v in enumerate(clique):
        if v < 0:
            return jj
    return len(clique)


def sizes_trunc(clique: list[int]) -> int:
    """The `>0` count of Group_Refinement (:1650)."""
    s = 0
    while s < len(clique) and clique[s] > 0:
        s += 1
    return s


def membership_counts(gd: GroupData, clique: list[int],
                      upto: int) -> np.ndarray:
    """Per row: in how many of clique[0:upto] groups it appears."""
    if upto == 0:
        return np.zeros(gd.groups.shape[1], np.int64)
    idx = np.array(clique[:upto], np.int64)
    return gd.groups[idx].sum(axis=0).astype(np.int64)


def _cutoff_sizes(m: np.ndarray, s_trunc: int,
                  mask: np.ndarray | None = None) -> np.ndarray:
    """sizes[t] = #rows (within mask) with membership m > t, for
    t in [0, s_trunc) — one bincount + suffix sum instead of s_trunc
    full-row scans (values of m are bounded by s_trunc)."""
    mv = m if mask is None else m[mask]
    cnt = np.bincount(mv, minlength=s_trunc + 1)
    return (mv.size - np.cumsum(cnt[:s_trunc])).astype(np.float64)


def clique_group(gd: GroupData, clique: list[int], c: int) -> np.ndarray:
    """CliqueGroup: rows in more than c of the clique's groups."""
    m = membership_counts(gd, clique, clique_len(clique))
    return m > c


def clique_coverage(gd: GroupData, clique: list[int],
                    c: int) -> np.ndarray:
    """CliqueCoverage (:1064-1096)."""
    upto = clique_len(clique)
    if upto == 0:
        return np.zeros(gd.coverage.shape[1], bool)
    cols = np.array(clique[:upto], np.int64) // 5
    m = gd.coverage[cols].sum(axis=0)
    return m > c


def core_cutoff(gr: int) -> int:
    """Core_Cutoff (:1589-1597); unused by the product path."""
    if gr < 100:
        p = 0.77
    elif gr < 1000:
        p = 0.83
    elif gr < 2000:
        p = 0.90
    else:
        p = 0.93
    return int(p * gr)


def core_group(gd: GroupData, clique: list[int], c: int) -> np.ndarray:
    """CoreGroup (:1011-1062): adaptive cutoff = first membership level
    whose group size drops to <= c; unused by the product path."""
    upto = clique_len(clique)
    m = membership_counts(gd, clique, upto)
    histo = np.array([(m > t).sum() for t in range(max(upto, 1))],
                     np.int64)
    i = 0
    while i < len(histo) and histo[i] > c:
        i += 1
    return m > i


def best_cutoff(n: int, nn: int, v: int, p: float, pp: float) -> int:
    """BestCutoff (:530-548); result unused by the product path."""
    bestc, bestscore = 0, 0.0
    for c in range(v):
        score = hg.binom_q(c, p, v) * n
        score /= max(hg.binom_q(c, pp, v) * nn, 1.0)
        if score > bestscore:
            bestscore = score
            bestc = c
    return bestc


def korrmax_cutoff(gd: GroupData, clique: list[int], s_trunc: int,
                   c: int, seed: int) -> int:
    """KorrMaxCutoff (:1393-1457); result unused by the product path.
    Note BOTH coverage arguments are the seed column's (:1422)."""
    m = membership_counts(gd, clique, s_trunc)
    maxps, max_i = 0.0, 0
    cov_seed = gd.coverage[seed // 5].astype(np.float64)
    for t in range(c, s_trunc):
        cg = (m > t).astype(np.float64)
        possig = group_positive_significance(
            cg, gd.groups[clique[0]].astype(np.float64),
            cov_seed, cov_seed)
        if possig > maxps:
            maxps = possig
            max_i = t
    return max_i


def dropoff_cutoff(sizes: np.ndarray, signumber: int,
                   c: int) -> tuple[int, float]:
    """Dropoff_Cutoff (:1460-1522) on precomputed cutoff-group sizes
    (len == Sizes[c_i]). Returns (drop_c, min_drop). Vectorized; the
    reference's strict running < keeps the FIRST minimum = argmin."""
    t0 = max(1, c)
    n = len(sizes) - 1
    if t0 >= n:
        return t0, 1000000.0
    sz = np.asarray(sizes, np.float64)[t0:n]
    lim = np.minimum(float(signumber) - sz, sz)
    with np.errstate(divide="ignore", invalid="ignore"):
        drop = np.where(lim > 0,
                        (sizes[t0 - 1:n - 1] - sizes[t0 + 1:n + 1])
                        / np.where(lim > 0, lim, 1.0), np.inf)
    i = int(np.argmin(drop))
    if drop[i] < 1000000.0:
        return t0 + i, float(drop[i])
    return t0, 1000000.0


@dataclass
class Refinement:
    maxcorrs: np.ndarray                 # possibly zeroed entries
    cliques: dict[int, list[int]] = field(default_factory=dict)
    sizes: dict[int, int] = field(default_factory=dict)
    cutoffs: dict[int, int] = field(default_factory=dict)
    dropoff: dict[int, float] = field(default_factory=dict)
    c_groups: dict[int, np.ndarray] = field(default_factory=dict)
    c_coverage: dict[int, np.ndarray] = field(default_factory=dict)


def _cliquer_from_stats(cand, z, seed, maxclique, greedy):
    """TheBestUpdater given precomputed candidate stats — identical to
    cliquer()'s tail. The sequential sorted-insert with strict
    comparison and arrival order (RepeatResolver.c:1156-1176) is
    exactly a stable descending sort truncated to maxclique-1 (ties
    keep arrival = candidate-index order; an arrival tied with the
    table bottom is dropped, as the sort places it after)."""
    keep = z > greedy
    if not keep.any():
        return [seed] + [-1] * (maxclique if cand.size else 1)
    ck = cand[keep]
    zk = z[keep]
    order = np.argsort(-zk, kind="stable")[:maxclique - 1]
    chosen = [int(v) for v in ck[order]]
    return ([seed] + chosen
            + [-1] * (maxclique - len(chosen)))


def komprimierung(u: np.ndarray) -> int:
    """Unterteilungskomprimierung (:1823-1843): renumber by first
    occurrence, -1 preserved; returns cluster count. In place."""
    nxt = 0
    seen: dict[int, int] = {}
    for i in range(len(u)):
        v = int(u[i])
        if v > -1:
            if v not in seen:
                seen[v] = nxt
                nxt += 1
            u[i] = seen[v]
    return nxt


def _sorted_significant(ref: Refinement, cutoff: float,
                        sizecutoff: int) -> list[int]:
    """Index list + the (Drop_Off asc, Sizes desc, MaxCorrs desc) sort
    of DropOff_Subdivision (:3186-3213); full ties keep index order."""
    idx = [i for i in range(len(ref.maxcorrs))
           if ref.maxcorrs[i] > cutoff and
           ref.sizes.get(i, 0) > sizecutoff]
    return sorted(idx, key=lambda i: (ref.dropoff.get(i, 1000.0),
                                      -ref.sizes.get(i, 0),
                                      -ref.maxcorrs[i]))


def dropoff_subdivision(ref: Refinement, cutoff: float,
                        dropoffcutoff: float, sizecutoff: int,
                        mingroup: int, signumber: int) -> np.ndarray:
    """DropOff_Subdivision (:3180-3271)."""
    order = _sorted_significant(ref, cutoff, sizecutoff)
    u = np.zeros(signumber, np.int64)
    number = 1
    number2 = 1
    for i in order:
        if ref.dropoff.get(i, 1000.0) < dropoffcutoff:
            cg = ref.c_groups[i]
            for k in range(number):
                mask = u == k
                drinne = int((cg & mask).sum())
                draus = int((~cg & mask).sum())
                if drinne > mingroup and draus > mingroup:
                    u[mask & cg] = number2
                    u[mask & ~cg] = number2 + 1
                    number2 += 2
            number = number2
            number = komprimierung(u)
    return u


def _komprimierung_vec(u: np.ndarray) -> int:
    """komprimierung in array operations: the same labels (the values
    above -1 renumbered by first occurrence) and count. In place."""
    keep = u > -1
    vals, first = np.unique(u[keep], return_index=True)
    rank = np.empty(len(vals), np.int64)
    rank[np.argsort(first)] = np.arange(len(vals))
    u[keep] = rank[np.searchsorted(vals, u[keep])]
    return len(vals)


def _dropoff_subdivision_vec(ref: Refinement, cutoff: float,
                             dropoffcutoff: float, sizecutoff: int,
                             mingroup: int, signumber: int) -> np.ndarray:
    """dropoff_subdivision with its cluster loop in array operations
    (the card route's; the same labels). Within one var i the loop's
    clusters k < number split independently: a split relabels only k's
    rows, to number2 and above (number2 >= number), so each k's counts
    are those before the loop; the splits take their labels in k
    order."""
    order = _sorted_significant(ref, cutoff, sizecutoff)
    u = np.zeros(signumber, np.int64)
    number = number2 = 1
    for i in order:
        if ref.dropoff.get(i, 1000.0) < dropoffcutoff:
            cg = ref.c_groups[i]
            tot = np.bincount(u, minlength=number)[:number]
            drinne = np.bincount(u[cg], minlength=number)[:number]
            split = (drinne > mingroup) & (tot - drinne > mingroup)
            ks = np.nonzero(split)[0]
            if ks.size:
                label = np.zeros(number, np.int64)
                label[ks] = number2 + 2 * np.arange(ks.size)
                moved = split[u]
                u[moved] = label[u[moved]] + (~cg[moved])
                number2 += 2 * ks.size
            number = _komprimierung_vec(u)
    return u


def relative_dropoff_cutoff(gd: GroupData, clique: list[int],
                            s_trunc: int, u: np.ndarray,
                            k: int, signumber: int,
                            c: int = 0,
                            m: np.ndarray | None = None) -> tuple[int,
                                                                  float]:
    """Relative_Dropoff_Cutoff (:2859-2920): cutoff groups restricted
    to cluster k's rows. m: precomputed membership_counts (it depends
    only on the clique, so callers looping over clusters hoist it)."""
    if m is None:
        m = membership_counts(gd, clique, s_trunc)
    sizes = _cutoff_sizes(m, s_trunc, u == k)
    return dropoff_cutoff(sizes, signumber, c)


def relative_dropoff_subdivision(gd: GroupData, ref: Refinement,
                                 u: np.ndarray, cutoff: float,
                                 dropoffcutoff: float, sizecutoff: int,
                                 mingroup: int,
                                 card: "CardGroups | None" = None) -> None:
    """RelativeDropoff_Subdivision (:3274-3378). Mutates u and
    ref.dropoff (both, like the reference). With `card`, the (cluster,
    var) loop's tests run at once on the device
    (_relative_dropoff_card)."""
    if card is not None:
        _relative_dropoff_card(card, gd, ref, u, cutoff, dropoffcutoff,
                               sizecutoff, mingroup)
        return
    signumber = len(u)
    idx = [i for i in range(len(ref.maxcorrs))
           if ref.maxcorrs[i] > cutoff
           and ref.sizes.get(i, 0) > sizecutoff]
    number = komprimierung(u)
    # membership depends only on the clique — hoist across the
    # (cluster k, var i) double loop; cg is pure, so it is only built
    # when the split test can actually use it.
    mtrunc: dict[int, np.ndarray] = {}
    mfull: dict[int, np.ndarray] = {}
    for k in range(number):
        ink = u == k
        if int(ink.sum()) > mingroup * 2:
            for i in idx:
                m = mtrunc.get(i)
                if m is None:
                    m = mtrunc[i] = membership_counts(
                        gd, ref.cliques[i], ref.sizes[i])
                c, min_drop = dropoff_cutoff(
                    _cutoff_sizes(m, ref.sizes[i], ink), signumber, 0)
                ref.dropoff[i] = min_drop       # global mutation kept
                if min_drop < dropoffcutoff:
                    mf = mfull.get(i)
                    if mf is None:
                        mf = mfull[i] = membership_counts(
                            gd, ref.cliques[i],
                            clique_len(ref.cliques[i]))
                    cg = mf > c
                    drinne = int((cg & ink).sum())
                    draus = int((~cg & ink).sum())
                    if drinne > mingroup and draus > mingroup:
                        u[ink & cg] = number + 1 + k * 2
                        u[ink & ~cg] = number + 2 + k * 2
                        ink = u == k            # split: now empty
    komprimierung(u)


def komplettierung(u: np.ndarray, ausgelassen: np.ndarray) -> np.ndarray:
    """UnterteilungsKomplettierung (:1845-1865)."""
    out = np.full(len(ausgelassen), -1, np.int64)
    out[ausgelassen == 1] = u
    return out


# ---- the functions that reach the exact products, on `device`


class CardGroups:
    """A window's one-hot groups [5w, n] and coverage [w, n] resident on
    a device as int8 (the card route), with the group sizes."""

    def __init__(self, gd: GroupData, device):
        self.dev = torch.device(device)
        self.groups = torch.from_numpy(
            np.ascontiguousarray(gd.groups).view(np.int8)).to(self.dev)
        self.coverage = torch.from_numpy(
            np.ascontiguousarray(gd.coverage).view(np.int8)).to(self.dev)
        self.sizes = torch.from_numpy(gd.sizes).to(self.dev)


# seeds a chunk of the card route's candidate statistics (its
# intermediates grow with it: ~28,000 candidates a seed at paper width)
CARD_SEED_CHUNK = 512
# bytes of the clique groups RelDrop's card pass gathers at once
RELDROP_CHUNK_BYTES = 1 << 26


def _unique_rows(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The distinct rows of an int64 [N, 6] tensor of counts below 2^21
    and each row's index among them (torch.unique(dim=0)'s pair, in
    another order): each half packed into one key, then the pair of the
    halves' ranks, three 1-d uniques."""
    if t.numel() and int(t.max()) >= 1 << 21:
        raise ValueError("candidate counts of 2^21 rows or more")
    mask = (1 << 21) - 1
    keys = [(t[:, i] << 42) | (t[:, i + 1] << 21) | t[:, i + 2]
            for i in (0, 3)]
    (u1, i1), (u2, i2) = (torch.unique(k, return_inverse=True)
                          for k in keys)
    n2 = u2.numel()
    key, inv = torch.unique(i1 * n2 + i2, return_inverse=True)
    halves = (u1[key // n2], u2[key % n2])
    rows = torch.stack([x for h in halves
                        for x in (h >> 42, (h >> 21) & mask, h & mask)], 1)
    return rows, inv


def _significance(tuples: np.ndarray, fast: bool) -> np.ndarray:
    """positive_significance (cap_base 97.90) of [U, 6] argument tuples
    (schnitt, gr1, gr2, cov, size1, size2), as the host route evaluates
    its candidates: in float64 behind the mode gate
    (positive_significance_fast), else on the int64 values."""
    cols = tuples.T.astype(np.float64) if fast else tuples.T
    return hg.positive_significance(*cols, cap_base=97.90)


def _cliques_card(card: CardGroups, seeds: np.ndarray, mincov: int,
                  maxclique: int, greedy: float, seed_chunk: int,
                  clock: SplitClock) -> dict[int, list[int]]:
    """_cliques_host's cliques with the statistics on card.dev: the four
    counts are exact int8 products over the resident matrices, the
    candidates and the mode gate torch ops there, the significance the
    host's own float64 function on the distinct argument tuples only,
    and TheBestUpdater (_cliquer_from_stats) a stable sort there."""
    dev = card.dev
    chunk = max(seed_chunk, CARD_SEED_CHUNK)
    grows = torch.nonzero(card.sizes > mincov // 4).flatten()
    gmat = card.groups.index_select(0, grows)            # [G, n]
    seeds_t = torch.from_numpy(seeds).to(dev)
    fast = greedy >= 2.0     # _cliques_host's choice of sig_fn
    cliques: dict[int, list[int]] = {}
    clock.lap("refine_products")
    for lo in range(0, len(seeds), chunk):
        sc = seeds_t[lo:lo + chunk]
        gseed = card.groups.index_select(0, sc)
        cseed = card.coverage.index_select(0, sc // 5)
        schnitt = devmm.int_matmul_t(gmat, gseed)        # [G, S]
        gr1 = devmm.int_matmul_t(gmat, cseed)            # [G, S]
        gr2 = devmm.int_matmul_t(card.coverage, gseed)   # [w, S]
        cov = devmm.int_matmul_t(card.coverage, cseed)   # [w, S]
        clock.lap("refine_products")
        # the host's candidates in its order: seed by seed, partner
        # groups ascending
        cand = ((schnitt.t() > mincov // 4)
                & (grows[None, :] != sc[:, None]))       # [S, G]
        si, gi = torch.nonzero(cand, as_tuple=True)
        col = grows[gi] // 5
        s_ = schnitt[gi, si].to(torch.int64)
        n_ = gr1[gi, si].to(torch.int64)
        k_ = gr2[col, si].to(torch.int64)
        nn = cov[col, si].to(torch.int64)
        if fast:
            # positive_significance_fast's gate: one torch op an IEEE
            # operation (no two fused, so no FMA), each correctly
            # rounded in float64, as numpy's
            f64 = torch.float64
            mode = (n_.to(f64) + 1.0) * (k_.to(f64) + 1.0) \
                / (nn.to(f64) + 2.0)
            rel = (s_.to(f64) > mode) & (s_ >= 1) & (n_ > 0) & (k_ > 0)
            ridx = torch.nonzero(rel).flatten()
        else:
            ridx = torch.arange(si.shape[0], device=dev)
        tup = torch.stack([s_[ridx], n_[ridx], k_[ridx], nn[ridx],
                           card.sizes[grows[gi[ridx]]],
                           card.sizes[sc[si[ridx]]]], 1)
        clock.count("refine_candidates", si.shape[0])
        clock.count("refine_relevant", ridx.shape[0])
        clock.lap("refine_candidates")
        z = torch.zeros(si.shape[0], dtype=torch.float64, device=dev)
        if ridx.numel():
            uq, inv = _unique_rows(tup)
            zu = _significance(uq.cpu().numpy(), fast)
            z[ridx] = torch.from_numpy(zu).to(dev)[inv]
            clock.count("refine_tuples", uq.shape[0])
        clock.lap("refine_significance")
        # TheBestUpdater: keep z > greedy; by seed, then z descending,
        # ties in candidate order (both sorts stable); the first
        # maxclique - 1 of each seed
        keep = torch.nonzero(z > greedy).flatten()
        keep = keep[torch.sort(z[keep], descending=True, stable=True).indices]
        keep = keep[torch.sort(si[keep], stable=True).indices]
        ks_ = si[keep]
        rank = torch.arange(keep.shape[0], device=dev) \
            - torch.searchsorted(ks_, ks_)
        chosen = keep[rank < maxclique - 1]
        ch_si = si[chosen].cpu().numpy()
        ch_g = grows[gi[chosen]].cpu().numpy()
        lens = torch.bincount(si, minlength=sc.shape[0]).cpu().numpy()
        bounds = np.searchsorted(ch_si, np.arange(sc.shape[0] + 1))
        for j, seed in enumerate(seeds[lo:lo + chunk].tolist()):
            chosen_j = [int(v) for v in ch_g[bounds[j]:bounds[j + 1]]]
            if not chosen_j:
                cliques[seed] = [seed] + [-1] * (maxclique if lens[j]
                                                 else 1)
            else:
                cliques[seed] = ([seed] + chosen_j
                                 + [-1] * (maxclique - len(chosen_j)))
        clock.lap("refine_cliquer")
    return cliques


def _relative_dropoff_card(card: CardGroups, gd: GroupData,
                           ref: Refinement, u: np.ndarray, cutoff: float,
                           dropoffcutoff: float, sizecutoff: int,
                           mingroup: int) -> None:
    """relative_dropoff_subdivision's loop with its tests on card.dev.

    Each cluster k the loop visits (more than 2 * mingroup rows) is split
    at most once, into labels above every cluster's, and only its own
    rows move: the clusters' decisions are independent. So for every
    (k, var i) at once: the cutoff sizes are counts of k's rows by
    membership (a histogram a pair, its suffix sums), dropoff_cutoff
    runs batched in float64 (each division one correctly rounded IEEE
    operation; argmin takes the first minimum, as the reference's strict
    < does), and the split test counts k's rows in the full clique's
    cutoff group. The host then applies each cluster's first splitting
    var and writes ref.dropoff as the loop leaves it: the last visited
    cluster's values, 1e6 for the vars after its split (the loop then
    sees the cluster empty)."""
    dev = card.dev
    signumber = len(u)
    idx = [i for i in range(len(ref.maxcorrs))
           if ref.maxcorrs[i] > cutoff
           and ref.sizes.get(i, 0) > sizecutoff]
    number = komprimierung(u)
    ks = [k for k in range(number) if int((u == k).sum()) > mingroup * 2]
    if not ks or not idx:
        komprimierung(u)
        return
    n_k, n_i = len(ks), len(idx)
    st = np.array([ref.sizes[i] for i in idx], np.int64)
    full = np.array([clique_len(ref.cliques[i]) for i in idx], np.int64)
    width = max(1, int(full.max()))
    cl = np.zeros((n_i, width), np.int64)
    for j, i in enumerate(idx):
        cl[j, :full[j]] = ref.cliques[i][:full[j]]
    nv = width + 1                      # membership values 0..width
    kidx = np.full(signumber, n_k, np.int64)      # n_k: not visited
    for j, k in enumerate(ks):
        kidx[u == k] = j
    kidx_t, cl_t, st_t, full_t = (torch.from_numpy(x).to(dev)
                                  for x in (kidx, cl, st, full))
    size_k = torch.bincount(kidx_t, minlength=n_k + 1)[:n_k, None]
    pos = torch.arange(width, device=dev)
    t = torch.arange(nv, device=dev)
    ok = torch.zeros((n_k, n_i), dtype=torch.bool, device=dev)
    c_all = torch.zeros((n_k, n_i), dtype=torch.int64, device=dev)
    d_all = torch.zeros((n_k, n_i), dtype=torch.float64, device=dev)
    step = max(1, RELDROP_CHUNK_BYTES // (width * signumber))
    for lo in range(0, n_i, step):
        hi = min(lo + step, n_i)
        g = card.groups[cl_t[lo:hi]]                     # [I, width, n]
        above = []                # [K, I, nv]: k's rows with m > t
        for upto in (st_t[lo:hi], full_t[lo:hi]):
            keep = (pos[None, :] < upto[:, None]).to(torch.int8)
            m = (g * keep[:, :, None]).sum(1)             # [I, n]
            rows = torch.arange(hi - lo, device=dev)[:, None]
            hist = torch.bincount(
                (((rows * (n_k + 1) + kidx_t[None, :]) * nv) + m).flatten(),
                minlength=(hi - lo) * (n_k + 1) * nv)
            hist = hist.view(hi - lo, n_k + 1, nv)[:, :n_k].transpose(0, 1)
            ge = hist.flip(2).cumsum(2).flip(2)           # m >= t
            above.append(torch.cat([ge[:, :, 1:],
                                    torch.zeros_like(ge[:, :, :1])], 2))
        # dropoff_cutoff(sizes[:st], signumber, 0), t in [1, st - 1)
        sizes = above[0].to(torch.float64)
        lim = torch.minimum(float(signumber) - sizes, sizes)
        inside = (t[None, None, :] >= 1) \
            & (t[None, None, :] < (st_t[lo:hi] - 1)[None, :, None]) \
            & (lim > 0)
        drop = torch.full_like(sizes, torch.inf)
        drop[:, :, 1:-1] = (sizes[:, :, :-2] - sizes[:, :, 2:]) \
            / torch.where(lim > 0, lim, 1.0)[:, :, 1:-1]
        drop = torch.where(inside, drop, torch.inf)
        t_min = torch.argmin(drop, 2)                     # first minimum
        d_min = drop.gather(2, t_min[:, :, None])[:, :, 0]
        hit = d_min < 1000000.0
        c = torch.where(hit, t_min, 1)
        d = torch.where(hit, d_min, 1000000.0)
        drinne = above[1].gather(2, c[:, :, None])[:, :, 0]
        ok[:, lo:hi] = (d < dropoffcutoff) & (drinne > mingroup) \
            & (size_k - drinne > mingroup)
        c_all[:, lo:hi] = c
        d_all[:, lo:hi] = d
    first = torch.argmax(ok.to(torch.int8), 1)           # first True
    split = ok.any(1)
    first_h, split_h = first.cpu().numpy(), split.cpu().numpy()
    c_h = c_all.gather(1, first[:, None])[:, 0].cpu().numpy()
    last = d_all[-1].cpu().numpy()
    if split_h[-1]:
        last[first_h[-1] + 1:] = 1000000.0
    for i, val in zip(idx, last.tolist()):
        ref.dropoff[i] = val
    for j, k in enumerate(ks):
        if split_h[j]:
            i = idx[first_h[j]]
            cg = membership_counts(gd, ref.cliques[i],
                                   clique_len(ref.cliques[i])) > c_h[j]
            ink = u == k
            u[ink & cg] = number + 1 + k * 2
            u[ink & ~cg] = number + 2 + k * 2
    komprimierung(u)


def _decisions(vals: np.ndarray, size: int, cutoff: float, s: np.ndarray,
               ib: np.ndarray, ia: np.ndarray) -> np.ndarray:
    """The decisions hg.cum_hyp_geo_log(s, gr_b, gr_a, size) > cutoff,
    with the host's argument types, at the entries (s, ib, ia) of a pair
    table over the distinct popcounts `vals` of clusters of `size` rows
    (cuda_resolver's layout: gr_b = vals[ib], gr_a = vals[ia])."""
    z = hg.cum_hyp_geo_log(s.astype(np.int64), vals[ib].astype(np.int64),
                           vals[ia].astype(np.int64),
                           np.full(s.shape, size))
    return z > cutoff


def _relative_vars_card(card: CardGroups, u: np.ndarray, ks: list[int],
                        maxcorrs: np.ndarray, cutoff: float, mingroup: int,
                        clock: SplitClock) -> dict[int, list[int]]:
    """relative_vars of every cluster in `ks` at once on card.dev: the
    clusters' intersections with every group as one exact product, the
    selected groups' memberships packed, and kernel H over all pairs (its
    plain version on CPU tensors) twice: a counting launch finds the
    entries that occur (bits of a table in shared memory up to
    cv.SMEM_TABLE_BYTES, keys in a hash past it), the host evaluates
    those alone, and a lookup launch marks the rows."""
    if not ks:
        return {}
    dev = card.dev
    u_t = torch.from_numpy(np.ascontiguousarray(u, np.int64)).to(dev)
    ks_t = torch.tensor(ks, dtype=torch.int64, device=dev)
    onehot = (u_t[None, :] == ks_t[:, None]).to(torch.int8)   # [K, n]
    inter = devmm.int_matmul_t(card.groups, onehot)          # [5w, K]
    clock.lap("relvars_product")
    sig = torch.from_numpy(maxcorrs > cutoff).to(dev)
    sel = sig[None, :] & (inter.t() >= mingroup)              # [K, 5w]
    kk, gg = torch.nonzero(sel, as_tuple=True)
    masks, gr, row_off, word_off, words, sizes = cv.pack_members(
        card.groups, u_t, ks_t, kk, gg)
    gr_h = gr.cpu().numpy()
    off_h = row_off.cpu().numpy()
    sizes_h = sizes.cpu().numpy()
    clock.lap("relvars_gather")

    # one table a cluster size, over the popcounts of its clusters: its
    # bits in shared memory up to cv.SMEM_TABLE_BYTES, else in the hash
    # at hbase
    k_n = len(ks)
    nsel = np.diff(off_h)
    gidx = np.zeros(len(gr_h), np.int32)
    tab_off = np.zeros(k_n, np.int32)
    tab_words = np.zeros(k_n, np.int32)
    dims = np.zeros(k_n, np.int32)
    kflag = np.zeros(k_n, np.int32)
    hbase = np.zeros(k_n, np.int64)
    bitmap, hashed = [], []   # (size, vals, word offset, words), (.., base)
    nwords = nbase = pairs_hashed = 0
    for size in np.unique(sizes_h):
        kl = np.nonzero(sizes_h == size)[0]
        rows = np.concatenate([np.arange(off_h[k], off_h[k + 1])
                               for k in kl])
        vals = np.unique(gr_h[rows]).astype(np.int64)
        d = len(vals)
        if d == 0:
            continue
        gidx[rows] = np.searchsorted(vals, gr_h[rows])
        dims[kl] = d
        tw = cv.bitmap_words(d, int(vals.max()))
        if tw * 4 <= cv.SMEM_TABLE_BYTES:
            kflag[kl], tab_off[kl], tab_words[kl] = cv.BITMAP, nwords, tw
            bitmap.append((int(size), vals, nwords, tw))
            nwords += tw
        else:
            n_entries = (int(vals.max()) + 1) * d * d
            kflag[kl] = cv.HASHED if n_entries < 2 ** 32 else cv.HASHED_WIDE
            hbase[kl] = nbase
            hashed.append((int(size), vals, nbase))
            nbase += n_entries
            pairs_hashed += int((nsel[kl] * (nsel[kl] - 1) // 2).sum())
    if nwords >= 2 ** 31 or nbase >= 2 ** 62:
        raise ValueError(f"relative_vars: {nwords} table words or "
                         f"{nbase} hashed entries pass the pass's offsets")

    def dev32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
    sel_t, rowk_t = gg.to(torch.int32), kk.to(torch.int32)
    p = cv.PairPass(masks=masks, sel=sel_t, gidx=dev32(gidx), rowk=rowk_t,
                    row_off=row_off, word_off=word_off, words=words,
                    tab_off=dev32(tab_off), tab_words=dev32(tab_words),
                    dims=dev32(dims), kflag=dev32(kflag),
                    hbase=torch.from_numpy(hbase).to(dev),
                    tiles=cv.pair_tiles(sel_t, rowk_t, row_off))
    tables = torch.zeros(max(nwords, 4), dtype=torch.int32, device=dev)
    occ = torch.zeros_like(tables)
    marked = torch.zeros((p.nrows + 31) // 32, dtype=torch.int32,
                         device=dev)
    # kernel H's own CUDA events, while ops/_build.kernel_events times
    # launches
    events = _build.kernel_events
    mark = len(events.get("resolver_pairs", ())) \
        if events is not None else None
    # pair_pass launches no pass without tiles
    launches = int(p.tiles.shape[0] > 0)

    def run(hsh, count):
        cv.pair_pass(p, tables, occ, hsh, marked, count=count)
        clock.count("relvars_h_launches", launches)

    # the hash: two slots a key for as many keys as the counted pairs or
    # the hashed tables' entries allow, grown on overflow (each regrow
    # one more counting launch)
    log2 = 1
    if hashed:
        log2 = min(max(min(pairs_hashed, nbase), 1).bit_length() + 1,
                   cv.HASH_LOG2_START)
    hsh = cv.PairHash.empty(log2, dev)
    clock.count("relvars_hashed_clusters", int((kflag != cv.BITMAP).sum()))
    while True:
        run(hsh, True)
        if not hsh.overflowed():
            break
        clock.count("relvars_hash_regrows", 1)
        hsh = cv.PairHash.empty(hsh.log2 + cv.HASH_LOG2_STEP, dev)
    evaluated = 0
    if bitmap:
        # the occurrence bits, read back as (word, bit) and decoded
        at = torch.nonzero(occ).flatten()
        w_h = at.cpu().numpy().astype(np.int64)
        v_h = occ[at].cpu().numpy().astype("<i4")
        bits = np.unpackbits(v_h.view(np.uint8).reshape(-1, 4), axis=1,
                             bitorder="little").astype(bool)
        word = np.repeat(w_h, bits.sum(1))
        bit = np.nonzero(bits)[1].astype(np.int64)
        offs = np.array([off for _, _, off, _ in bitmap], np.int64)
        t_of = np.searchsorted(offs, word, side="right") - 1
        hit = np.zeros(word.shape, bool)
        for t, (size, vals, off, _) in enumerate(bitmap):
            at_t = np.nonzero(t_of == t)[0]
            rr, ss = cv.table_geometry(len(vals))
            s, rest = np.divmod(word[at_t] - off, ss)
            ib, iw = np.divmod(rest, rr)
            ia = iw * 32 + bit[at_t]
            if ((ib >= len(vals)) | (ia >= len(vals))
                    | (s > vals.max())).any():
                raise AssertionError("relative_vars: an occurrence bit "
                                     "outside its table's entries")
            hit[at_t] = _decisions(vals, size, cutoff, s, ib, ia)
        evaluated += word.size
        clock.count("relvars_bitmap_entries", int(word.size))
        cv.or_words(tables, torch.from_numpy(word[hit]).to(dev),
                    torch.from_numpy(bit[hit]).to(dev))
    if hashed:
        slots = torch.nonzero(hsh.keys).flatten()
        keys = (hsh.keys[slots] - 1).cpu().numpy()
        bases = np.array([b for *_, b in hashed], np.int64)
        t_of = np.searchsorted(bases, keys, side="right") - 1
        hit = np.zeros(keys.shape, bool)
        for t, (size, vals, base) in enumerate(hashed):
            at_t = np.nonzero(t_of == t)[0]
            d = len(vals)
            s, rest = np.divmod(keys[at_t] - base, d * d)
            ib, ia = np.divmod(rest, d)
            hit[at_t] = _decisions(vals, size, cutoff, s, ib, ia)
        evaluated += keys.size
        hsh.bits[slots[torch.from_numpy(hit).to(dev)]] = 1
        clock.count("relvars_hash_keys", int(keys.size))
    clock.count("relvars_tuples", evaluated)
    run(hsh, False)
    marked_h = cv.unpack_marks(marked, p.nrows)
    gg_h = gg.cpu().numpy()
    if mark is not None:
        h = events.get("resolver_pairs", [])[mark:]
        if h:
            h[-1][1].synchronize()
        clock.count("relvars_h_ms", sum(a.elapsed_time(b) for a, b in h))
    clock.count("relvars_rows", p.nrows)
    clock.count("relvars_clusters", k_n)
    clock.count("relvars_tiles", int(p.tiles.shape[0]))
    clock.lap("relvars_pairs")
    return {k: [int(v) for v in gg_h[off_h[i]:off_h[i + 1]][
        marked_h[off_h[i]:off_h[i + 1]]]] for i, k in enumerate(ks)}


def group_refinement(gd: GroupData, maxcorrs: np.ndarray, cutoff: float,
                     mincov: int, maxclique: int, greedy: float,
                     min_clique_size: int = 5, seed_chunk: int = 128,
                     device="cuda", split: SplitClock | None = None,
                     card: "CardGroups | None" = None) -> Refinement:
    """Group_Refinement (RepeatResolver.c:1634-1690) on a copy of
    maxcorrs: per-seed candidate statistics as chunked products over all
    significant seeds, then the greedy TheBestUpdater tail per seed.
    With `card` (the window's groups resident on a device) the
    statistics and the clique choice run there (_cliques_card);
    otherwise on the host with the exact products above the devmm gate
    on `device`."""
    clock = split or SplitClock()
    mc = maxcorrs.copy()
    ref = Refinement(maxcorrs=mc)
    signumber = gd.groups.shape[1]
    seeds = np.nonzero(mc > cutoff)[0]
    if card is not None:
        cliques = _cliques_card(card, seeds, mincov, maxclique, greedy,
                                seed_chunk, clock)
    else:
        cliques = _cliques_host(gd, seeds, mincov, maxclique, greedy,
                                seed_chunk, device, clock)

    for i in range(len(mc)):
        if mc[i] <= cutoff:
            continue
        clique = cliques[i]
        st = sizes_trunc(clique)
        if st > min_clique_size:
            m = membership_counts(gd, clique, st)
            sizes = _cutoff_sizes(m, st)
            drop_c, min_drop = dropoff_cutoff(sizes, signumber, 0)
            ref.cliques[i] = clique
            ref.sizes[i] = st
            ref.cutoffs[i] = drop_c
            ref.dropoff[i] = min_drop
            ref.c_groups[i] = clique_group(gd, clique, drop_c)
            ref.c_coverage[i] = clique_coverage(gd, clique, drop_c)
        else:
            mc[i] = 0.0
    clock.lap("refine_tail")
    return ref


def _cliques_host(gd: GroupData, seeds: np.ndarray, mincov: int,
                  maxclique: int, greedy: float, seed_chunk: int, device,
                  clock: SplitClock) -> dict[int, list[int]]:
    """The JAX package's candidate statistics and cliques, on the host:
    float32 BLAS products (the exact products above the devmm gate on
    `device`) and the significance of every relevant candidate."""
    _cliques_host.calls += 1
    gf = gd.groups.astype(np.float32)
    covf = gd.coverage.astype(np.float32)
    gsizes = gd.sizes
    # partners must pass schnitt > mincov//4, which groups of size
    # <= mincov//4 never can: filter the group matrix once
    grows = np.nonzero(gsizes > mincov // 4)[0]
    gff = gf[grows]                                  # [G, R]
    # the [G, R] group matrix is reused by every seed chunk: one device
    # copy for the window
    gff_o = devmm.Operand(gd.groups[grows])
    use_dev = devmm.device_enabled(device)
    cliques: dict[int, list[int]] = {}
    clock.lap("refine_products")
    for lo in range(0, len(seeds), seed_chunk):
        sc = seeds[lo:lo + seed_chunk]
        gseed = gf[sc]                               # [S, R]
        covseed = covf[sc // 5]                      # [S, R]
        schnitt_i = devmm.matmul_t(gff_o, gd.groups[sc], device).astype(
            np.int64)                                # [G, S]
        clock.lap("refine_products")
        # sub-mode pairs have true Z < ~0.5: with greedy above 2 the
        # mode-gated evaluator decides every candidate identically
        sig_fn = (hg.positive_significance_fast if greedy >= 2.0
                  else hg.positive_significance)
        # one significance call per seed chunk (values are per element);
        # coverage-side products only at the unique candidate rows
        candg_list = []
        for si, seed in enumerate(sc):
            candg_list.append(np.nonzero(
                (schnitt_i[:, si] > mincov // 4)
                & (grows != seed))[0])
        cand_list = [grows[cg] for cg in candg_list]
        lens = np.array([cd.size for cd in cand_list])
        clock.lap("refine_candidates")
        if lens.sum():
            catg = np.concatenate(candg_list)
            catc = grows[catg]
            si_rep = np.repeat(np.arange(len(sc)), lens)
            if use_dev:
                # one [G, S] product on the device copy of the group
                # matrix instead of the unique-candidate host product
                gr1_full = devmm.matmul_t(gff_o, gd.coverage[sc // 5],
                                          device)
                gr1v = gr1_full[catg, si_rep].astype(np.int64)
            else:
                ug, ug_inv = np.unique(catg, return_inverse=True)
                gr1u = gff[ug] @ covseed.T           # [Ug, S]
                gr1v = gr1u[ug_inv, si_rep].astype(np.int64)
            uc, uc_inv = np.unique(catc // 5, return_inverse=True)
            cu = covf[uc]                            # [Uc, R]
            gr2u = cu @ gseed.T                      # [Uc, S]
            covu = cu @ covseed.T                    # [Uc, S]
            clock.lap("refine_products")
            z_all = sig_fn(
                schnitt_i[catg, si_rep],
                gr1v,
                gr2u[uc_inv, si_rep].astype(np.int64),
                covu[uc_inv, si_rep].astype(np.int64),
                gsizes[catc], gsizes[sc[si_rep]],
                cap_base=97.90)
            clock.count("refine_candidates", int(lens.sum()))
            clock.lap("refine_significance")
        bounds = np.concatenate([[0], np.cumsum(lens)])
        for si, seed in enumerate(sc):
            z = (z_all[bounds[si]:bounds[si + 1]]
                 if lens[si] else np.zeros(0))
            cliques[int(seed)] = _cliquer_from_stats(
                cand_list[si], z, int(seed), maxclique, greedy)
        clock.lap("refine_cliquer")
    return cliques


_cliques_host.calls = 0


def relative_vars(gd: GroupData, u: np.ndarray, u_no: int,
                  maxcorrs: np.ndarray, cutoff: float, mingroup: int,
                  device="cuda", split: SplitClock | None = None
                  ) -> list[int]:
    """Relative_Vars (RepeatResolver.c:2424-2493), on the host (the
    exact product above the devmm gate on `device`)."""
    relative_vars.calls += 1
    clock = split or SplitClock()
    sel = maxcorrs > cutoff
    u_group = (u == u_no)
    inter = gd.groups[:, u_group].sum(axis=1)
    sel &= inter >= mingroup            # < mingroup dropped
    sel_idx = np.nonzero(sel)[0]
    if sel_idx.size == 0:
        clock.lap("relvars_gather")
        return []
    # pairwise within the cluster, j >= i + 100 (>= 20 columns)
    sub = gd.groups[np.ix_(sel_idx, np.nonzero(u_group)[0])]
    clock.lap("relvars_gather")
    schnitt = devmm.matmul_t(sub, sub, device)
    gr = sub.sum(axis=1).astype(np.int64)
    cov = int(u_group.sum())
    clock.lap("relvars_product")
    marked = np.zeros(sel_idx.size, bool)
    # every (a, b) pair with sel_idx[b] >= sel_idx[a] + 100, in blocks of
    # seed rows (one hypergeometric call per block; per-element values)
    n = sel_idx.size
    block = max(1, int(2_000_000) // n)
    for a0 in range(0, n, block):
        a1 = min(a0 + block, n)
        pa, pb = np.nonzero(
            sel_idx[None, :] >= sel_idx[a0:a1, None] + 100)
        if pa.size == 0:
            continue
        pa = pa + a0
        z = hg.cum_hyp_geo_log(
            schnitt[pb, pa].astype(np.int64), gr[pb], gr[pa],
            np.full(pa.shape, cov))
        hits = z > cutoff
        marked[pa[hits]] = True
        marked[pb[hits]] = True
        clock.count("relvars_pairs", int(pa.size))
    clock.lap("relvars_pairs")
    return [int(v) for v in sel_idx[marked]]


# host-route calls (the card route must leave both at 0)
relative_vars.calls = 0


def _grmatch_matrix(a: np.ndarray, b: np.ndarray, sc: int,
                    device="cuda") -> np.ndarray:
    """GrMatch over bit-vectors: sc*64 - hamming (RepeatResolver.c:
    141-153), the intersections as one exact product."""
    if a.shape[1] == 0:
        both = np.zeros((a.shape[0], b.shape[0]), np.int64)
    else:
        both = devmm.matmul_t(a, b, device).astype(np.int64)
    ham = (a.sum(1).astype(np.int64)[:, None]
           + b.sum(1).astype(np.int64)[None, :] - 2 * both)
    return sc * 64 - ham


def kmeans(gd: GroupData, u: np.ndarray, u_no: int, vars_: list[int],
           mingroup: int, use_native: bool = True, device="cuda") -> int:
    """Kmeans (RepeatResolver.c:2604-2821), a literal simulation (the
    native C++ helpers, or with use_native=False the same
    order-dependent loops in Python). Mutates u."""
    varzahl = len(vars_)
    members = np.nonzero(u == u_no)[0]
    anzahl = len(members)
    if anzahl == 0:
        return 0
    sc = varzahl // 64 + 1
    if varzahl:
        varsigs = gd.groups[np.ix_(np.array(vars_, np.int64),
                                   members)].T        # [anzahl, varzahl]
    else:
        varsigs = np.zeros((anzahl, 0), bool)
    score_m = _grmatch_matrix(varsigs, varsigs, sc, device)

    # top-5 slot machine per row (:2656-2703)
    centroids = None
    if use_native:
        centroids = native.kmeans_top5_centroids(
            score_m, varsigs.astype(np.uint8)).astype(bool)
    if centroids is None:
        centroids = np.zeros((anzahl, varzahl), bool)
        for i in range(anzahl):
            bs = [0] * 5
            bj = [0] * 5
            row = score_m[i]
            for j in range(anzahl):
                # ascending selection pass
                for k in range(5):
                    for l in range(k + 1, 5):
                        if bs[l] < bs[k]:
                            bs[k], bs[l] = bs[l], bs[k]
                            bj[k], bj[l] = bj[l], bj[k]
                s = int(row[j])
                if s > bs[0]:
                    bs[0] = s
                    bj[0] = j
            if varzahl:
                centroids[i] = varsigs[bj].sum(axis=0) > 2
    cent_scores = _grmatch_matrix(centroids, varsigs, sc, device)

    clusternumber = None
    if use_native:
        clusternumber = native.kmeans_assign_dissolve(
            cent_scores, mingroup).astype(np.int64)
    if clusternumber is None:
        clusternumber = np.zeros(anzahl, np.int64)
        clustersize = np.zeros(anzahl, np.int64)
        for i in range(anzahl):
            best_s, best_j = 0, 0
            col = cent_scores[:, i]
            for j in range(anzahl):
                if int(col[j]) > best_s and i != j:
                    best_s = int(col[j])
                    best_j = j
            clusternumber[i] = best_j
            clustersize[best_j] += 1

        for mn in range(2, mingroup):
            for i in range(anzahl):
                if clustersize[clusternumber[i]] <= mn:
                    best_s, best_j = 0, 0
                    col = cent_scores[:, i]
                    for j in range(anzahl):
                        if clustersize[j] >= mn \
                                and clusternumber[i] != j \
                                and int(col[j]) > best_s and i != j:
                            best_s = int(col[j])
                            best_j = j
                    clustersize[clusternumber[i]] -= 1
                    clusternumber[i] = best_j
                    clustersize[best_j] += 1

    aufgeteilt = int((np.bincount(clusternumber,
                                  minlength=anzahl) > 0).sum())
    max_u = int(u.max())
    u[members] = clusternumber + max_u + 1
    return aufgeteilt


def kmeans_subdivision(gd: GroupData, ref: Refinement, u: np.ndarray,
                       cutoff: float, mingroup: int, device="cuda",
                       split: SplitClock | None = None,
                       card: "CardGroups | None" = None) -> None:
    """Kmeans_Subdivision (RepeatResolver.c:3382-3403). Mutates u. With
    `card`, every cluster's relative_vars runs first, in one pass on the
    device (_relative_vars_card)."""
    clock = split or SplitClock()
    number = komprimierung(u)
    # the clusters the loop subdivides, decided up front: kmeans(k)
    # relabels only cluster k's rows, to labels above u.max() >=
    # number - 1, so no cluster k' < number gains or loses a row
    ks = [k for k in range(number) if int((u == k).sum()) > mingroup * 2]
    # for the same reason, and because nothing here touches
    # ref.maxcorrs, relative_vars(k) is the same before the first kmeans
    # as after the kmeans of the clusters below k: the card route runs
    # them all at once
    vars_all = (_relative_vars_card(card, u, ks, ref.maxcorrs, cutoff,
                                    mingroup, clock)
                if card is not None else None)
    for k in ks:
        vars_ = (vars_all[k] if vars_all is not None else
                 relative_vars(gd, u, k, ref.maxcorrs, cutoff, mingroup,
                               device, clock))
        kmeans(gd, u, k, vars_, mingroup, device=device)
        clock.lap("kmeans")
    komprimierung(u)


# -------------------------------------------------- flank connection


def probability_chain(subdivisions: list[np.ndarray]) -> np.ndarray:
    """Multi_Verbindungen (:2029-2165): chained row-normalized
    transition matrices over a list of clusterings (-1 = missing)."""
    us = [np.asarray(s, np.int64).copy() for s in subdivisions]
    maxes = [komprimierung(x) for x in us]
    mats = []
    for j in range(len(us) - 1):
        a, b = us[j], us[j + 1]
        m = np.zeros((maxes[j], maxes[j + 1]))
        ok = (a > -1) & (b > -1)
        np.add.at(m, (a[ok], b[ok]), 1.0)
        card = m.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(card > 0.5, m / np.maximum(card, 1e-300), 0.0)
        mats.append(m)
    out = mats[0]
    for m in mats[1:]:
        out = out @ m
    return out


def back_and_forth(subdivisions: list[np.ndarray]) -> np.ndarray:
    """Back_And_Forth (:2170-2226): forward chain x transpose of the
    backward chain, elementwise."""
    fwd = probability_chain(subdivisions)
    bwd = probability_chain(subdivisions[::-1])
    return fwd * bwd.T


def resolve_window(msa: np.ndarray, maxcorrs_full: np.ndarray,
                   von: int, bis: int, cfg: ResolverConfig,
                   device="cuda", route: str | None = None
                   ) -> dict[str, np.ndarray]:
    """The reference main (RepeatResolver.c:3863-4084): the three
    clusterings expanded to all MSA rows ("cuda" raises without a GPU).

    route "card": the window's groups resident on `device`, where
    group_refinement's candidate statistics and cliques and every
    relative_vars' pair pass run (kernel H on a CUDA device, its plain
    version on CPU tensors); "host": the JAX package's host code, with
    the exact products above the devmm gate on `device`. None takes
    "card" on a CUDA device unless RR_RESOLVER_DEVICE is "0", else
    "host". Both give the same subdivisions. Each call appends its
    record (seconds, the SplitClock parts and tallies, peak device
    memory) to resolve_window.log."""
    device = resolve_device(device)
    if route is None:
        route = ("card" if device.type == "cuda"
                 and devmm.device_enabled(device) else "host")
    if route not in ("card", "host"):
        raise ValueError(f"unknown resolve route {route!r}")
    clock = SplitClock(device)
    t0 = time.perf_counter()
    win = extract_window(msa, von, bis)
    gd = GroupData.from_window(win)
    card = CardGroups(gd, device) if route == "card" else None
    w = win.siglength
    # MaxCorrs slice: file rows with i/5 in [von, bis] (:629-638)
    mc = maxcorrs_full.reshape(-1, 5)[von:win.bis + 1].reshape(-1)
    mc = mc.astype(np.float64).copy()
    cutoff = cfg.resolved_cutoff(w)

    covcount = gd.covcount
    maxcov = int(covcount.max()) if w else 0
    kill = (covcount * 10 < maxcov * 9)
    mc[np.repeat(kill, 5)] = 0.0
    clock.lap("extract")

    ref = group_refinement(gd, mc, cutoff, cfg.cov, cfg.maxclique,
                           cutoff, cfg.min_clique_size, device=device,
                           split=clock, card=card)
    mingroup = cfg.mingroup
    u = (_dropoff_subdivision_vec if card is not None
         else dropoff_subdivision)(ref, cutoff, cfg.dropoffcutoff,
                                   cfg.sizecutoff, mingroup, win.signumber)
    out = {"Dropoff": komplettierung(u, win.ausgelassen)}
    clock.lap("dropoff")
    relative_dropoff_subdivision(gd, ref, u, cutoff, cfg.dropoffcutoff,
                                 cfg.sizecutoff, mingroup, card=card)
    out["RelDrop"] = komplettierung(u, win.ausgelassen)
    clock.lap("reldrop")
    kmeans_subdivision(gd, ref, u, cutoff, mingroup, device, split=clock,
                       card=card)
    out["Kmeans"] = komplettierung(u, win.ausgelassen)
    rec = {"window": [int(von), int(bis)], "route": route,
           "device": str(device), "rows": int(win.signumber), "cols": w,
           "seeds": int((mc > cutoff).sum()),
           "s": time.perf_counter() - t0, "split": dict(clock.s),
           **clock.counts}
    if device.type == "cuda":
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    resolve_window.log.append(rec)
    return out


# one record a resolve_window call (see there); callers clear it
resolve_window.log = []


def run(msa_path: str, von: int, bis: int, cfg: ResolverConfig,
        maxcorrs_path: str | None = None,
        device="cuda") -> dict[str, np.ndarray]:
    """CLI equivalent: reads the MSA and MaxCorrsOf_<msa>, writes the
    three subdivision files under the reference's names."""
    msa = rio.read_msa(msa_path)
    if maxcorrs_path is None:
        maxcorrs_path = rio.maxcorrs_path(msa_path)
    mc = rio.read_maxcorrs(maxcorrs_path)
    out = resolve_window(msa, mc, von, bis, cfg, device)
    for kind, u in out.items():
        rio.write_subdivision(
            rio.subdivision_path(kind, von, bis, msa_path), u)
    return out
