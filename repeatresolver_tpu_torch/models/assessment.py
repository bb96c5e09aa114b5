"""Accuracy assessment vs ground truth.

Copied from repeatresolver_tpu/models/assessment.py (same functions, same bytes
written and read).

Ports the math of SimDataAssessment.py and TransposonAssessment.py
(numpy throughout; the mutual-best-match scoring is exactly the
reference's):

  * ResolutionQuality (SimDataAssessment.py:269-351): recall matrix x
    precision matrix, row-normalized, mutual-best-match counting.
  * MultiStepResolution (:359-429): chained transition-matrix products
    forward and backward over FlankingLeft + windows + FlankingRight,
    elementwise fwd * back^T.
  * Resolvability (TransposonAssessment.py:97-119): separable ground
    truth groups by consensus distance over significant columns.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils import io as rio


def group_maker(resolution: np.ndarray) -> list[np.ndarray]:
    """GroupMaker: non-empty label groups for labels 0..max
    (SimDataAssessment.py:266-267). Label -1 ignored."""
    resolution = np.asarray(resolution)
    out = []
    for x in range(int(resolution.max()) + 1):
        g = np.nonzero(resolution == x)[0]
        if g.size:
            out.append(g)
    return out


@dataclass
class QualityResult:
    truepositives: int
    falsepositives: int
    conconfpositives: list[int]     # resolved at confidence > c/10
    theresolved: np.ndarray         # 1 resolved, -1 false, 0 unresolved
    maxis: np.ndarray


def _mutual_best(matrix3: np.ndarray) -> QualityResult:
    n = len(matrix3)
    conconf = [0] * 10
    tp = fp = 0
    theresolved = np.zeros(n, np.int64)
    maxis = np.zeros(n)
    for t in range(n):
        maxi, maxtt = 0.0, 0
        for tt in range(n):
            if matrix3[t][tt] > maxi:
                maxi = matrix3[t][tt]
                maxtt = tt
        row_of_max = matrix3[maxtt][:n]
        if maxi == row_of_max.max():
            if maxtt != t:
                fp += 1
                theresolved[t] = -1
            else:
                theresolved[t] = 1
                tp += 1
                for c in range(10):
                    if maxi > c / 10.0:
                        conconf[c] += 1
        maxis[t] = maxi
    return QualityResult(tp, fp, conconf, theresolved, maxis)


def resolution_quality(ground_truth: np.ndarray,
                       resolution: np.ndarray,
                       mask_unassigned: bool = True) -> QualityResult:
    """ResolutionQuality. The two reference scripts differ:
    SimDataAssessment.py:269-279 restricts ground-truth groups to rows
    the resolution assigned (GroundTruthResolution2); the transposon
    variant (TransposonAssessment.py:163-170) uses the RAW ground-truth
    groups, so unassigned rows deflate the recall fractions. Default is
    the SimData behavior; pass mask_unassigned=False for the transposon
    contract (golden-tested in tests/test_golden_transposon.py)."""
    ground_truth = np.asarray(ground_truth)
    resolution = np.asarray(resolution)
    gt2 = (np.where(resolution > -1, ground_truth, -1)
           if mask_unassigned else ground_truth)
    groups = group_maker(gt2)
    nres = int(resolution.max()) + 1
    m1 = np.zeros((len(groups), nres))
    m2 = np.zeros((nres, len(groups)))
    for tt, g in enumerate(groups):
        size = float(len(g))
        for ttt in range(nres):
            m1[tt, ttt] = (resolution[g] == ttt).sum() / size
    counts = np.bincount(resolution[resolution > -1].astype(np.int64),
                         minlength=nres) if (resolution > -1).any() \
        else np.zeros(nres, np.int64)
    # reference counts Resolution.count(ttt) over the raw list, which
    # includes -1 rows only for label -1 (never queried)
    counts_raw = np.array([(resolution == ttt).sum()
                           for ttt in range(nres)], np.float64)
    for ttt in range(nres):
        size = counts_raw[ttt]
        if size > 0:
            for tt, g in enumerate(groups):
                m2[ttt, tt] = (resolution[g] == ttt).sum() / size
    m3 = m1 @ m2
    sums = m3.sum(axis=1, keepdims=True)
    m3 = np.where(sums > 0.0, m3 / np.where(sums == 0, 1, sums), m3)
    return _mutual_best(m3)


def probability_matrix(res1: np.ndarray, res2: np.ndarray) -> np.ndarray:
    """ProbabilityMatrix (SimDataAssessment.py:359-370)."""
    res1 = np.asarray(res1)
    res2 = np.asarray(res2)
    n1 = int(res1.max()) + 1
    n2 = int(res2.max()) + 1
    m = np.zeros((n1, n2))
    ok = (res1 > -1) & (res2 > -1)
    np.add.at(m, (res1[ok], res2[ok]), 1.0)
    sums = np.array([((res1 == t) & (res2 > -1)).sum()
                     for t in range(n1)], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.where(sums[:, None] > 0, m / np.where(
            sums[:, None] == 0, 1, sums[:, None]), m)
    return m


def multi_step_resolution(flanking_left: np.ndarray,
                          resolutions: list[np.ndarray],
                          flanking_right: np.ndarray) -> tuple[
                              np.ndarray, QualityResult]:
    """MultiStepResolution (SimDataAssessment.py:372-426)."""
    allres = [np.asarray(flanking_left)] + \
        [np.asarray(r) for r in resolutions] + \
        [np.asarray(flanking_right)]
    n = len(allres)
    fwd = [probability_matrix(allres[r], allres[r + 1])
           for r in range(n - 1)]
    bwd = [probability_matrix(allres[n - 1 - r], allres[n - 2 - r])
           for r in range(n - 1)]
    f = fwd[0] @ fwd[1]
    b = bwd[0] @ bwd[1]
    for t in range(2, n - 1):
        f = f @ fwd[t]
        b = b @ bwd[t]
    concon = f * b.T
    sums = concon.sum(axis=1, keepdims=True)
    concon = np.where(sums > 0.0,
                      concon / np.where(sums == 0, 1, sums), concon)
    return concon, _mutual_best(concon)


# -------------------------------------------------- dataset assessment


@dataclass
class SimDataset:
    """The file set SimDataAssessment autodiscovers (its :18-175)."""
    read2copy: np.ndarray
    read2place: np.ndarray
    seq2read: np.ndarray
    seqclass: list[str]
    msa2seq: np.ndarray
    unique2seq: np.ndarray

    @classmethod
    def load(cls, directory: str, recompute_seq2read: bool = False):
        d = directory
        files = os.listdir(d)

        def find(suffix, exclude=()):
            for p in sorted(files):
                if p.endswith(suffix) and not any(
                        p.endswith(e) for e in exclude):
                    return os.path.join(d, p)
            raise FileNotFoundError(suffix)

        read2copy = rio.read_ints(find("_ReadCopynumbers"))
        read2place = rio.read_ints(find("_ReadPlacements"))
        seq2read = rio.read_readseqinfo(find("_ReadSeqInfo"))
        seqclass = [l.strip() for l in
                    open(find("_SeqClass")).read().splitlines()]
        msa2seq = np.array([i for i, c in enumerate(seqclass)
                            if c == "r"], np.int64)
        unique2seq = np.array([i for i, c in enumerate(seqclass)
                               if c != "r"], np.int64)
        if recompute_seq2read:
            # SimDataAssessment.py:211-224 substring recomputation
            seqs = rio.read_fasta(find("_Seq.fasta"))
            reads = rio.read_fasta(
                find(".fasta", exclude=("_Seq.fasta",
                                        "_Template.fasta")))
            seq2read = cls._seq2read_substring(seqs, reads)
        return cls(read2copy, read2place, seq2read, seqclass,
                   msa2seq, unique2seq)

    @staticmethod
    def _seq2read_substring(seqs, reads) -> np.ndarray:
        out = []
        r = s = 0
        reads_b = [rr.tobytes() for rr in reads]
        while s < len(seqs) and r < len(reads):
            if seqs[s][:100].tobytes() in reads_b[r]:
                out.append(r)
                s += 1
            else:
                r += 1
        return np.array(out, np.int64)

    def ground_truth_resolution(self) -> np.ndarray:
        """Read2Copy ∘ Seq2Reads ∘ MSA2Seq (SimDataAssessment.py:264)."""
        return self.read2copy[self.seq2read[self.msa2seq]]

    def flanking(self) -> tuple[np.ndarray, np.ndarray]:
        """Flanking clusters (SimDataAssessment.py:227-244): the copy id
        when the neighboring seq exists, is unique-class, and belongs to
        the same read; else -1."""
        uniq = set(self.unique2seq.tolist())
        n = len(self.msa2seq)
        left = np.full(n, -1, np.int64)
        right = np.full(n, -1, np.int64)
        ns = len(self.seq2read)
        for t in range(n):
            s = int(self.msa2seq[t])
            if s + 1 in uniq and s + 1 < ns and \
                    self.seq2read[s + 1] == self.seq2read[s]:
                right[t] = self.read2copy[self.seq2read[s]]
            if s - 1 in uniq and s - 1 >= 0 and \
                    self.seq2read[s - 1] == self.seq2read[s]:
                left[t] = self.read2copy[self.seq2read[s]]
        return left, right


def assess_directory(dataset_dir: str, resolution_dir: str,
                     prefix: str = "KmeansSubdivisionOf_"):
    """End-to-end SimDataAssessment: per-window quality + multi-step
    flank-to-flank connection."""
    ds = SimDataset.load(dataset_dir)
    resolutions = []
    for p in sorted(os.listdir(resolution_dir)):
        if p.startswith(prefix):
            start = int(p.split("_")[1])
            resolutions.append(
                (start, rio.read_ints(os.path.join(resolution_dir, p))))
    resolutions = [r for _, r in sorted(resolutions,
                                        key=lambda t: t[0])]
    gt = ds.ground_truth_resolution()
    singles = [resolution_quality(gt, res) for res in resolutions]
    left, right = ds.flanking()
    _, multi = multi_step_resolution(left, resolutions, right)
    return singles, multi


# ------------------------------------------------ transposon metrics


def konsensus(rows: np.ndarray) -> np.ndarray:
    """Majority base per column, spaces never win
    (TransposonAssessment.py:82-92)."""
    counts = np.zeros((rows.shape[1], 6), np.int64)
    for s in range(6):
        counts[:, s] = (rows == s).sum(axis=0)
    counts[:, 5] = 0
    return counts.argmax(axis=1).astype(np.int8)


def diff(sig1: np.ndarray, sig2: np.ndarray) -> int:
    """Mismatches ignoring spaces (TransposonAssessment.py:94-95)."""
    return int(((sig1 != sig2) & (sig1 != 5) & (sig2 != 5)).sum())


def signatures(msa: np.ndarray, col_maxcorrs: np.ndarray,
               cutoff: float, start: int, ende: int) -> np.ndarray:
    """SignaturesMaker (TransposonAssessment.py:156-157): significant
    columns of the window start/5..ende/5."""
    cols = np.arange(start // 5, ende // 5)
    cols = cols[col_maxcorrs[cols] > cutoff]
    return msa[:, cols]


def resolvability(ground_truth: np.ndarray,
                  sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Resolvability (TransposonAssessment.py:97-119): per group the min
    consensus distance to any other group; plus the unique-group counts
    at thresholds 0..10."""
    groups = group_maker(ground_truth)
    kons = np.stack([konsensus(sigs[g]) for g in groups])
    n = len(kons)
    mindiffs = np.zeros(n, np.int64)
    summe = np.zeros(11, np.int64)
    for k in range(n):
        unique = np.ones(11, np.int64)
        mind = 1000000
        d = 0
        for kk in range(n):
            if k != kk:
                d = diff(kons[k], kons[kk])
                mind = min(mind, d)
                unique[d:] = 0
        mindiffs[k] = d          # reference records the LAST diff (quirk)
        summe += unique
    return mindiffs, summe


def half_resolvability(ground_truth: np.ndarray, sigs: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, dict]:
    """HalfResolvability (TransposonAssessment.py:121-154): min consensus
    distance per group computed separately on the first and second half
    of the signature; counts how often >5-diff separability in one half
    predicts it in the other. Returns (mindiffs1, mindiffs2, counters)."""
    groups = group_maker(ground_truth)
    kons = np.stack([konsensus(sigs[g]) for g in groups])
    n = len(kons)
    half = kons.shape[1] // 2
    md1 = np.full(n, 10000, np.int64)
    md2 = np.full(n, 10000, np.int64)
    for k in range(n):
        for kk in range(n):
            if k != kk:
                md1[k] = min(md1[k], diff(kons[k, :half], kons[kk, :half]))
                md2[k] = min(md2[k], diff(kons[k, half:], kons[kk, half:]))
    counters = {
        "biggerbigger": int(((md1 > 5) & (md2 > 5)).sum()),
        "biggersmaller": int(((md1 > 5) & (md2 <= 5)).sum()),
        "smallerbigger": int(((md1 <= 5) & (md2 > 5)).sum()),
        "smallersmaller": int(((md1 <= 5) & (md2 <= 5)).sum()),
    }
    return md1, md2, counters
