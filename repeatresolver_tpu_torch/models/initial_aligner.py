"""Template-anchored initial MSA.

Counterpart of repeatresolver_tpu/models/initial_aligner.py. The glocal
alignments come from one of two routes, as in the JAX package: the
native C++ kernels on the host (repeatresolver_tpu/utils/native.
initial_align, full DP, and initial_align_banded, the anchored band; it
raises without the native library), or the full edit DP with its
backtrack as torch ops on a device (ops/editdp.align_on_device, the
route the JAX package takes on an accelerator, which has no band).
Building_MSA (InitialAligner.c:553-663) is reproduced exactly, including
its two load-bearing quirks (Gapcount over every sequence, class 'l'
included; the leading-run spill that makes a row ragged).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repeatresolver_tpu.config import InitialAlignerConfig

from ..device import resolve_device
from ..ops import editdp

GAP = 4
_KMER = 15
# the device route's batch rows and bound on the move codes [Lq, B, Lt]
# int8 (the JAX package's are 16 rows and 1 GiB). Rows are independent,
# so neither changes a result; on an 80 GB card the per-position Python
# loop, not the arithmetic, sets the time, so fewer, wider batches win.
DEVICE_BATCH = 256
CODES_BUDGET = 1 << 34


class TemplateIndex:
    """Sorted unique k-mer index of the template (the band's anchors)."""

    def __init__(self, template: np.ndarray, k: int = _KMER):
        from numpy.lib.stride_tricks import sliding_window_view
        self.k = k
        t = np.asarray(template, np.int64)
        self.tlen = len(t)
        self.pw = (np.int64(4) ** np.arange(k)).astype(np.int64)
        if self.tlen < k:
            self.keys = np.empty(0, np.int64)
            self.order = np.empty(0, np.int64)
            self.uniq = np.empty(0, bool)
            return
        keys = sliding_window_view(t, k) @ self.pw
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        uniq = np.ones(len(sk), bool)
        if len(sk) > 1:
            dup = sk[1:] == sk[:-1]
            uniq[1:] &= ~dup
            uniq[:-1] &= ~dup
        self.keys, self.order, self.uniq = sk, order, uniq

    def anchors(self, seq: np.ndarray):
        """(x, j) exact unique k-mer hits at sampled query positions."""
        from numpy.lib.stride_tricks import sliding_window_view
        lq = len(seq)
        k = self.k
        if lq < k or len(self.keys) == 0:
            return None
        w = sliding_window_view(np.asarray(seq, np.int64), k)
        stride = max(1, min(64, lq // 256))
        xs = np.arange(0, lq - k + 1, stride)
        qk = w[xs] @ self.pw
        idx = np.minimum(np.searchsorted(self.keys, qk),
                         len(self.keys) - 1)
        hit = (self.keys[idx] == qk) & self.uniq[idx]
        if hit.sum() < 2:
            return None
        return xs[hit], self.order[idx[hit]]


def anchor_centers(tindex: TemplateIndex, seq: np.ndarray,
                   outlier: int = 3000) -> np.ndarray | None:
    """Monotone band-centre path (1-based template columns) for one
    piece, or None when the piece has fewer than 2 consistent anchors."""
    a = tindex.anchors(seq)
    if a is None:
        return None
    hx, hj = a
    d = hj.astype(np.int64) - hx
    keep = np.abs(d - np.median(d)) <= outlier
    hx, hj = hx[keep], hj[keep]
    if len(hx) < 2:
        return None
    mono = np.maximum.accumulate(hj) == hj
    hx, hj = hx[mono], hj[mono]
    lq = len(seq)
    cen = np.interp(np.arange(lq), hx, hj.astype(np.float64))
    x0, xl = int(hx[0]), int(hx[-1])
    cen[:x0] = hj[0] - (x0 - np.arange(x0))
    cen[xl:] = hj[-1] + (np.arange(lq - xl))
    return np.maximum.accumulate(
        np.clip(np.round(cen) + 1, 1, tindex.tlen)).astype(np.int32)


def scaled_diagonal(lq: int, tlen: int) -> np.ndarray:
    return np.clip(((np.arange(lq) + 1.0) * tlen / max(lq, 1)).astype(
        np.int64), 1, tlen).astype(np.int32)


@dataclass
class InitialMSAResult:
    msa: np.ndarray | None        # int8 [rows_r, width]; None if ragged
    rows: list[np.ndarray]        # every emitted row (class 'r'), int8
    seqclass: list[str]           # 'r'/'l' per input seq
    errors: np.ndarray            # AlignmentError per seq (NaN possible)
    alignments: list[np.ndarray]  # per seq: template col per base or -1
    gapcount: np.ndarray          # int32 [T+1]


def align_all(template: np.ndarray, seqs: list[np.ndarray],
              band: int = 0, device="cpu", use_native: bool | None = None
              ) -> tuple[list[np.ndarray], np.ndarray]:
    """IntoAligner over all seqs: alignments and error rates.

    use_native=None takes the native kernels for device "cpu" and the
    device edit DP on `device` otherwise; False forces the device route
    (also on "cpu"). On the native route, band > 0 aligns anchored
    pieces (and long anchor-less ones, on the length-scaled diagonal) in
    a band around their centre path, short anchor-less pieces with the
    exact full DP; the device route ignores band."""
    dev = resolve_device(device)
    if use_native is None:
        use_native = dev.type == "cpu"
    if use_native:
        return _align_native(template, seqs, band)
    return _align_device(template, seqs, dev)


def _align_native(template, seqs, band):
    from repeatresolver_tpu.utils import native as nat
    if nat.get_lib() is None:
        raise RuntimeError("native host library unavailable: align needs "
                           "native/libhostops.so (built with g++)")
    tlen = len(template)
    n = len(seqs)
    errors = np.full(n, np.nan)
    alignments: list[np.ndarray] = [np.empty(0, np.int32)] * n
    tindex = TemplateIndex(template) if band > 0 else None
    tpl8 = template.astype(np.int8)
    for lo in range(0, n, 512):
        chunk = seqs[lo:lo + 512]
        lens = np.array([len(s) for s in chunk], np.int32)
        lmax = max(1, int(lens.max()))
        padded = np.full((len(chunk), lmax), 100, np.int8)
        for i, s in enumerate(chunk):
            padded[i, :len(s)] = s
        if band > 0:
            centers = np.ones((len(chunk), lmax), np.int32)
            full_idx = []
            for i, s in enumerate(chunk):
                cen = anchor_centers(tindex, s)
                if cen is None:
                    if len(s) <= max(4000, band):
                        full_idx.append(i)
                        continue
                    cen = scaled_diagonal(len(s), tlen)
                centers[i, :len(s)] = cen
            aligned, errs = nat.initial_align_banded(tpl8, padded, lens,
                                                     centers, band)
            if full_idx:
                sub = np.array(full_idx)
                fa, fe = nat.initial_align(tpl8, padded[sub], lens[sub])
                aligned[sub] = fa
                errs[sub] = fe
        else:
            aligned, errs = nat.initial_align(tpl8, padded, lens)
        for i in range(len(chunk)):
            alignments[lo + i] = aligned[i, :lens[i]].copy()
            errors[lo + i] = errs[i]
    return alignments, errors


def _bucket(x: int) -> int:
    """Length bucket: powers of two from 256, the JAX package's batch
    groups (there, one compiled shape each)."""
    b = 256
    while b < x:
        b *= 2
    return b


def _align_device(template, seqs, dev):
    """Length-sorted batches through editdp.align_on_device (the backtrack
    stays on the device; only alignments and final rows come back)."""
    tlen = len(template)
    n = len(seqs)
    errors = np.full(n, np.nan)
    alignments: list[np.ndarray] = [np.empty(0, np.int32)] * n
    order = np.argsort([len(s) for s in seqs], kind="stable")
    # long uncut pieces (reads with no first/last template-part hit stay
    # whole, ReadCutter.c:600-601) push Lq to read length: the batch
    # shrinks with Lq*Lt to bound the move codes
    buckets = np.array([_bucket(max(1, len(seqs[i]))) for i in order])
    starts = []
    pos = 0
    while pos < n:
        lq = int(buckets[pos])
        b_eff = int(max(1, min(DEVICE_BATCH,
                               CODES_BUDGET // (lq * max(tlen, 1)))))
        end = pos
        while end < n and end - pos < b_eff and buckets[end] == lq:
            end += 1
        starts.append((pos, end, lq))
        pos = end
    target = torch.from_numpy(template.astype(np.int16)).to(dev)
    for lo, hi, lq in starts:
        idxs = order[lo:hi]
        lens_real = np.array([len(seqs[i]) for i in idxs], np.int32)
        # a batch runs to its longest piece, not to the bucket: DP rows
        # past every piece's end reach no output
        q = np.full((len(idxs), max(1, int(lens_real.max()))), 100,
                    np.int16)                           # query pad 100
        for r, i in enumerate(idxs):
            q[r, :lens_real[r]] = seqs[i]
        aligned, fr = editdp.align_on_device(
            torch.from_numpy(q).to(dev),
            torch.from_numpy(lens_real).to(dev), target)
        aligned = aligned.cpu().numpy()
        fr = fr.cpu().numpy()
        for r, i in enumerate(idxs):
            nl = int(lens_real[r])
            if nl == 0:
                errors[i] = np.nan
                alignments[i] = np.empty(0, np.int32)
            else:
                entry = editdp.entry_column(fr[r])
                errors[i] = fr[r, entry] / nl
                alignments[i] = aligned[r, :nl].copy()
    return alignments, errors


def compute_gapcount(alignments: list[np.ndarray],
                     tlen: int) -> np.ndarray:
    """Building_MSA:571-597. Leading runs attribute to the first aligned
    base's column; later runs to (previous col + 1)."""
    gapcount = np.zeros(tlen + 1, np.int64)
    for a in alignments:
        if len(a) == 0:
            continue
        placed = np.nonzero(a >= 0)[0]
        if placed.size == 0:
            raise AssertionError(
                "sequence with no aligned base: reference behavior is "
                "undefined (OOB scan, InitialAligner.c:581)")
        prev_end = -1
        slot = int(a[placed[0]])       # leading-run slot
        for p in placed:
            run = p - prev_end - 1
            if run > 0 and run > gapcount[slot]:
                gapcount[slot] = run
            slot = int(a[p]) + 1
            prev_end = p
        run = len(a) - prev_end - 1    # trailing run
        if run > 0 and run > gapcount[slot]:
            gapcount[slot] = run
    return gapcount


def emit_row(seq: np.ndarray, a: np.ndarray, gapcount: np.ndarray,
             tlen: int) -> np.ndarray:
    """Building_MSA:612-641 emission for one class-'r' row (int8 codes;
    4 = '-'), including the leading-run spill that makes a ragged row."""
    n = len(seq)
    placed = np.nonzero(a >= 0)[0] if n else np.empty(0, np.int64)
    width = int(tlen + 1 + gapcount.sum())
    if n == 0:
        return np.full(width, GAP, np.int8)
    leading = int(placed[0]) if placed.size else n
    if leading <= gapcount[0]:
        out = np.full(width, GAP, np.int8)
        gap_end = np.cumsum(gapcount)          # end of slot i's gap region
        base_pos = gap_end + np.arange(tlen + 1)  # slot i's base cell
        gap_start = base_pos - gapcount
        if placed.size:
            out[base_pos[a[placed]]] = seq[placed]
            # runs after each placed base go to slot col+1, left-aligned
            bounds = np.concatenate([placed, [n]])
            for k in range(placed.size):
                run = int(bounds[k + 1]) - int(placed[k]) - 1
                if run:
                    s = gap_start[int(a[placed[k]]) + 1]
                    out[s:s + run] = seq[placed[k] + 1:placed[k] + 1 + run]
        if leading:
            out[0:leading] = seq[:leading]
        return out
    # spill: literal reference emission (ragged row)
    out = []
    k = 0
    for i in range(tlen + 1):
        count = 0
        while k < n and a[k] == -1:
            out.append(int(seq[k]))
            k += 1
            count += 1
        out.extend([GAP] * max(0, int(gapcount[i]) - count))
        if k < n and a[k] == i:
            out.append(int(seq[k]))
            k += 1
        else:
            out.append(GAP)
    return np.array(out, np.int8)


def build_initial_msa(template: np.ndarray, seqs: list[np.ndarray],
                      cfg: InitialAlignerConfig, device="cpu",
                      use_native: bool | None = None) -> InitialMSAResult:
    """Building_MSA over the alignments of align_all (its routes)."""
    tlen = len(template)
    alignments, errors = align_all(template, seqs, band=cfg.band,
                                   device=device, use_native=use_native)
    gapcount = compute_gapcount([a for a in alignments if len(a)], tlen)
    rows: list[np.ndarray] = []
    seqclass: list[str] = []
    for seq, a, err in zip(seqs, alignments, errors):
        if err < cfg.error_cutoff:  # NaN compares False, like C
            seqclass.append("r")
            rows.append(emit_row(np.asarray(seq), a, gapcount, tlen))
        else:
            seqclass.append("l")
    widths = {len(r) for r in rows}
    msa = np.stack(rows).astype(np.int8) if len(widths) == 1 and rows \
        else None
    return InitialMSAResult(msa=msa, rows=rows, seqclass=seqclass,
                            errors=errors, alignments=alignments,
                            gapcount=gapcount.astype(np.int32))


def write_outputs(res: InitialMSAResult, msa_path, seqclass_path) -> None:
    from repeatresolver_tpu.utils import io as rio
    with open(msa_path, "wb") as f:
        for row in res.rows:
            f.write(rio.CODE2BASE[row].tobytes() + b"\n")
    with open(seqclass_path, "w") as f:
        for c in res.seqclass:
            f.write(c + "\n")
