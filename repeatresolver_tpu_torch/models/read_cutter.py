"""Cut reads into repeat/flank instances against the template.

Counterpart of repeatresolver_tpu/models/read_cutter.py. The last DP
rows of the two mapped template parts come from one of two routes, as in
the JAX package: the native C++ kernel on the host (repeatresolver_tpu/
utils/native.occurrence_rows; it raises without the native library) or
the edit DP as torch ops on a device (ops/editdp.last_rows, the route
the JAX package takes on an accelerator). The occurrence-region scan,
the candidate loops and the greedy cut chain are the reference's
(quirky) host logic, reproduced exactly (ReadCutter.c:489-742, quirks
documented in the JAX module).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repeatresolver_tpu.config import ReadCutterConfig

from ..device import resolve_device
from ..ops import editdp


def occurrence_positions(final_row: np.ndarray, readlen: int,
                         part_len: int, cutoff: int) -> list[int]:
    """ReadCutter.c:489-568 region scan over the last DP row: end
    positions of detected occurrences, in descending scan order."""
    fr = np.asarray(final_row[:readlen])
    below = fr < cutoff
    positions: list[int] = []
    idx = np.arange(1, readlen)
    b = below[1:readlen]
    if b.size == 0:
        return positions
    change = np.nonzero(np.diff(b.astype(np.int8)))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change, [b.size - 1]])
    runs = [(int(idx[s]), int(idx[e]))
            for s, e in zip(starts, ends) if b[s]]
    # descending scan; a run reaching column 1 is never closed
    prev_min = None          # min of the region immediately above
    prev_lo = None
    for lo, hi in reversed(runs):
        if lo < 2:
            continue
        seg = fr[lo:hi + 1]
        mn = int(seg.min())
        # ties pick the largest column (descending scan, strict '<')
        einstieg = int(hi - np.argmin(seg[::-1]))
        # lastmin only holds the previous region's min when exactly one
        # above-cutoff cell separates the regions
        lastmin = prev_min if (prev_lo is not None
                               and prev_lo - hi == 2) else 100000
        if positions:
            if positions[-1] - einstieg > part_len // 2:
                positions.append(einstieg)
            elif lastmin > mn:
                positions[-1] = einstieg
        else:
            positions.append(einstieg)
        prev_min = mn
        prev_lo = lo
    return positions


def _candidates(entries: list[tuple[int, int]], parts: int, plen: int,
                readlen: int) -> list[int]:
    """The four candidate loops of ReadCutter.c:659-716, in order."""
    cand = [p for p, idx in entries
            if idx == parts - 1 and p > plen and readlen - p > plen]
    if parts > 1:
        for p, idx in entries:
            if idx == 0 and p - plen > plen and \
                    readlen - (p - plen) > plen:
                cand.append(p - plen)
        for p, idx in entries:
            if idx == parts - 2 and p + plen > plen and \
                    readlen - (p + plen) > plen:
                cand.append(p + plen)
        for p, idx in entries:
            if idx == 1 and p - 2 * plen > plen and \
                    readlen - (p - 2 * plen) > plen:
                cand.append(p - 2 * plen)
    return cand


def _greedy_chain(cand: list[int], tlen: int) -> list[int]:
    """ReadCutter.c:719-742: first cut < 1.5*T, then repeatedly the first
    candidate inside (last + T/2, last + 1.5*T). Selections are written
    back into the candidate array at index Cutting_Number, clobbering
    candidates not yet scanned, as the reference does."""
    cp = list(cand)
    j = len(cp)
    cn = 0
    for i in range(j):
        if cp[i] < tlen + tlen // 2:
            cp[cn] = cp[i]
            cn += 1
            break
    if cn == 0:
        return []
    for _k in range(60):
        for i in range(j):
            if cp[cn - 1] + tlen // 2 < cp[i] < \
                    cp[cn - 1] + tlen + tlen // 2:
                if cn < len(cp):
                    cp[cn] = cp[i]
                else:
                    cp.append(cp[i])
                cn += 1
                break
    return cp[:cn]


@dataclass
class CutResult:
    cutting_points: list[list[int]]   # per read
    pieces: list[np.ndarray]          # all pieces, reads in order
    seqs_per_read: list[int]


def cut_reads(template: np.ndarray, reads: list[np.ndarray],
              cfg: ReadCutterConfig, device="cpu",
              use_native: bool | None = None) -> CutResult:
    """Full ReadCutter behaviour over a read set. use_native=None takes
    the native host kernel for device "cpu" and the device edit DP on
    `device` otherwise; False forces the device route (also on "cpu")."""
    dev = resolve_device(device)
    if use_native is None:
        use_native = dev.type == "cpu"
    parts = cfg.parts
    steps = len(template) // parts
    plen = steps + cfg.overlap
    cutoff = int(plen * cfg.error_cutoff)
    tlen = len(template)
    # template parts; beyond the template the reference holds bytes that
    # never match a base: sentinel 100
    ext = np.concatenate([template.astype(np.int16),
                          np.full(tlen, 100, np.int16)])
    part_first = ext[0:plen]
    part_last = ext[(parts - 1) * steps:(parts - 1) * steps + plen]

    readlens = np.array([len(r) for r in reads], np.int32)
    lt = max(1, int(readlens.max()))
    n = len(reads)
    if use_native:
        from repeatresolver_tpu.utils import native as nat
        if nat.get_lib() is None:
            raise RuntimeError("native host library unavailable: cut "
                               "needs native/libhostops.so (built with "
                               "g++)")
        padded = np.full((n, lt), 99, np.int8)
        for j in range(n):
            padded[j, :readlens[j]] = reads[j]
        rows0, rows_last = (nat.occurrence_rows(part.astype(np.int8),
                                                padded, readlens)
                            for part in (part_first, part_last))
    else:
        # query = template part, target = read (pad sentinel 200), in
        # the JAX package's batches of 64 reads
        batch_size = 64
        rows0 = np.empty((n, lt), np.int32)
        rows_last = np.empty((n, lt), np.int32)
        qlens = torch.full((batch_size,), plen, dtype=torch.int32,
                           device=dev)
        queries = [torch.from_numpy(part).to(dev)[None, :].expand(
            batch_size, plen) for part in (part_first, part_last)]
        for lo in range(0, n, batch_size):
            hi = min(n, lo + batch_size)
            tgt = np.full((batch_size, lt), 200, np.int16)
            for j in range(lo, hi):
                tgt[j - lo, :readlens[j]] = reads[j]
            tgt_d = torch.from_numpy(tgt).to(dev)
            for q, dst in zip(queries, (rows0, rows_last)):
                dst[lo:hi] = editdp.last_rows(q, qlens, tgt_d).cpu(
                ).numpy()[:hi - lo]

    cutting_points: list[list[int]] = []
    for j in range(n):
        rl = int(readlens[j])
        pos0 = occurrence_positions(rows0[j], rl, plen, cutoff)
        pos_last = (occurrence_positions(rows_last[j], rl, plen, cutoff)
                    if parts > 1 else pos0)
        # stale-buffer quirk: indices 1..parts-2 all carry part 0's hits
        entries: list[tuple[int, int]] = []
        for i in range(parts):
            src = pos0 if i < parts - 1 or parts == 1 else pos_last
            entries.extend((p, i) for p in src)
        entries.sort(key=lambda t: t[0])
        cand = _candidates(entries, parts, plen, rl)
        # parts == 1: no greedy chain (ReadCutter.c:681)
        cutting_points.append(_greedy_chain(cand, tlen) if parts > 1
                              else cand)

    pieces: list[np.ndarray] = []
    seqs_per_read: list[int] = []
    for j, read in enumerate(reads):
        cuts = cutting_points[j]
        bounds = [0] + cuts + [len(read)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            pieces.append(np.asarray(read[a:b]))
        seqs_per_read.append(len(cuts) + 1)
    return CutResult(cutting_points, pieces, seqs_per_read)
