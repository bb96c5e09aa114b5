"""Windowed copy-group clustering (the reference RepeatResolver).

Counterpart of repeatresolver_tpu/models/resolver.py. The seven
functions that reach the exact resolver matmuls (group_refinement,
relative_vars, _grmatch_matrix, kmeans, kmeans_subdivision,
resolve_window, run) are ported here and route those products through
the port's ops/devmm on the caller's `device`; every other piece of
the clustering (window extraction, the DropOff / RelativeDropoff
subdivisions, the clique bookkeeping) is the JAX module's, whose top
level imports no jax. The JAX module's own versions of the seven must
not be called: its devmm gate imports jax.
"""
from __future__ import annotations

import numpy as np

from repeatresolver_tpu.config import ResolverConfig
from repeatresolver_tpu.models.resolver import (GroupData, Refinement,
                                                _cliquer_from_stats,
                                                _cutoff_sizes, clique_group,
                                                clique_coverage, dropoff_cutoff,
                                                dropoff_subdivision,
                                                extract_window, komplettierung,
                                                komprimierung,
                                                membership_counts,
                                                relative_dropoff_subdivision,
                                                sizes_trunc)
from repeatresolver_tpu.ops import hypergeom as hg

from ..ops import devmm

__all__ = ["group_refinement", "kmeans", "kmeans_subdivision",
           "relative_vars", "resolve_window", "run"]


def group_refinement(gd: GroupData, maxcorrs: np.ndarray, cutoff: float,
                     mincov: int, maxclique: int, greedy: float,
                     min_clique_size: int = 5, seed_chunk: int = 128,
                     device="cpu") -> Refinement:
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
                  device="cpu") -> list[int]:
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
                    device="cpu") -> np.ndarray:
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
           mingroup: int, use_native: bool = True, device="cpu") -> int:
    """Kmeans (RepeatResolver.c:2604-2821), a literal simulation (the
    native C++ helpers when available, with the same order-dependent
    semantics). Mutates u."""
    from repeatresolver_tpu.utils import native

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
        cent = native.kmeans_top5_centroids(score_m,
                                            varsigs.astype(np.uint8))
        if cent is not None:
            centroids = cent.astype(bool)
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
        cn = native.kmeans_assign_dissolve(cent_scores, mingroup)
        if cn is not None:
            clusternumber = cn.astype(np.int64)
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
                       device="cpu") -> None:
    """Kmeans_Subdivision (RepeatResolver.c:3382-3403). Mutates u."""
    number = komprimierung(u)
    for k in range(number):
        if int((u == k).sum()) > mingroup * 2:
            vars_ = relative_vars(gd, u, k, ref.maxcorrs, cutoff,
                                  mingroup, device)
            kmeans(gd, u, k, vars_, mingroup, device=device)
    komprimierung(u)


def resolve_window(msa: np.ndarray, maxcorrs_full: np.ndarray,
                   von: int, bis: int, cfg: ResolverConfig,
                   device="cpu") -> dict[str, np.ndarray]:
    """The reference main (RepeatResolver.c:3863-4084): the three
    clusterings expanded to all MSA rows. `device` is where the exact
    products above the devmm gate run."""
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
        device="cpu") -> dict[str, np.ndarray]:
    """CLI equivalent: reads the MSA and MaxCorrsOf_<msa>, writes the
    three subdivision files under the reference's names."""
    from repeatresolver_tpu.utils import io as rio
    msa = rio.read_msa(msa_path)
    if maxcorrs_path is None:
        maxcorrs_path = rio.maxcorrs_path(msa_path)
    mc = rio.read_maxcorrs(maxcorrs_path)
    out = resolve_window(msa, mc, von, bis, cfg, device)
    for kind, u in out.items():
        rio.write_subdivision(
            rio.subdivision_path(kind, von, bis, msa_path), u)
    return out
