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
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import ResolverConfig
from ..device import resolve_device
from ..ops import devmm
from ..ops import hypergeom as hg
from ..utils import io as rio
from ..utils import native

__all__ = ["group_refinement", "kmeans", "kmeans_subdivision",
           "relative_vars", "resolve_window", "run"]


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
                                 mingroup: int) -> None:
    """RelativeDropoff_Subdivision (:3274-3378). Mutates u and
    ref.dropoff (both, like the reference)."""
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


def group_refinement(gd: GroupData, maxcorrs: np.ndarray, cutoff: float,
                     mincov: int, maxclique: int, greedy: float,
                     min_clique_size: int = 5, seed_chunk: int = 128,
                     device="cuda") -> Refinement:
    """Group_Refinement (RepeatResolver.c:1634-1690) on a copy of
    maxcorrs: per-seed candidate statistics as chunked products over all
    significant seeds, then the greedy TheBestUpdater tail per seed."""
    mc = maxcorrs.copy()
    ref = Refinement(maxcorrs=mc)
    signumber = gd.groups.shape[1]
    seeds = np.nonzero(mc > cutoff)[0]
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
    for lo in range(0, len(seeds), seed_chunk):
        sc = seeds[lo:lo + seed_chunk]
        gseed = gf[sc]                               # [S, R]
        covseed = covf[sc // 5]                      # [S, R]
        schnitt_i = devmm.matmul_t(gff_o, gd.groups[sc], device).astype(
            np.int64)                                # [G, S]
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
            z_all = sig_fn(
                schnitt_i[catg, si_rep],
                gr1v,
                gr2u[uc_inv, si_rep].astype(np.int64),
                covu[uc_inv, si_rep].astype(np.int64),
                gsizes[catc], gsizes[sc[si_rep]],
                cap_base=97.90)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        for si, seed in enumerate(sc):
            z = (z_all[bounds[si]:bounds[si + 1]]
                 if lens[si] else np.zeros(0))
            cliques[int(seed)] = _cliquer_from_stats(
                cand_list[si], z, int(seed), maxclique, greedy)

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
    return ref


def relative_vars(gd: GroupData, u: np.ndarray, u_no: int,
                  maxcorrs: np.ndarray, cutoff: float, mingroup: int,
                  device="cuda") -> list[int]:
    """Relative_Vars (RepeatResolver.c:2424-2493)."""
    sel = maxcorrs > cutoff
    u_group = (u == u_no)
    inter = gd.groups[:, u_group].sum(axis=1)
    sel &= inter >= mingroup            # < mingroup dropped
    sel_idx = np.nonzero(sel)[0]
    if sel_idx.size == 0:
        return []
    # pairwise within the cluster, j >= i + 100 (>= 20 columns)
    sub = gd.groups[np.ix_(sel_idx, np.nonzero(u_group)[0])]
    schnitt = devmm.matmul_t(sub, sub, device)
    gr = sub.sum(axis=1).astype(np.int64)
    cov = int(u_group.sum())
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
    return [int(v) for v in sel_idx[marked]]


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
                       cutoff: float, mingroup: int,
                       device="cuda") -> None:
    """Kmeans_Subdivision (RepeatResolver.c:3382-3403). Mutates u."""
    number = komprimierung(u)
    for k in range(number):
        if int((u == k).sum()) > mingroup * 2:
            vars_ = relative_vars(gd, u, k, ref.maxcorrs, cutoff,
                                  mingroup, device)
            kmeans(gd, u, k, vars_, mingroup, device=device)
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
                   device="cuda") -> dict[str, np.ndarray]:
    """The reference main (RepeatResolver.c:3863-4084): the three
    clusterings expanded to all MSA rows. `device` is where the exact
    products above the devmm gate run ("cuda" raises without a GPU)."""
    device = resolve_device(device)
    win = extract_window(msa, von, bis)
    gd = GroupData.from_window(win)
    w = win.siglength
    # MaxCorrs slice: file rows with i/5 in [von, bis] (:629-638)
    mc = maxcorrs_full.reshape(-1, 5)[von:win.bis + 1].reshape(-1)
    mc = mc.astype(np.float64).copy()
    cutoff = cfg.resolved_cutoff(w)

    covcount = gd.covcount
    maxcov = int(covcount.max()) if w else 0
    kill = (covcount * 10 < maxcov * 9)
    mc[np.repeat(kill, 5)] = 0.0

    ref = group_refinement(gd, mc, cutoff, cfg.cov, cfg.maxclique,
                           cutoff, cfg.min_clique_size, device=device)
    mingroup = cfg.mingroup
    u = dropoff_subdivision(ref, cutoff, cfg.dropoffcutoff,
                            cfg.sizecutoff, mingroup, win.signumber)
    out = {"Dropoff": komplettierung(u, win.ausgelassen)}
    relative_dropoff_subdivision(gd, ref, u, cutoff, cfg.dropoffcutoff,
                                 cfg.sizecutoff, mingroup)
    out["RelDrop"] = komplettierung(u, win.ausgelassen)
    kmeans_subdivision(gd, ref, u, cutoff, mingroup, device)
    out["Kmeans"] = komplettierung(u, win.ausgelassen)
    return out


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
