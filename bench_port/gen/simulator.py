"""Simulated repeat copies and reads, with each read's true path.

A frozen copy of the port's simulator (`repeatresolver_tpu_torch/models/
simulator.py`, itself the reference DataSimulator.py re-done in numpy),
kept here so that no later change to the program moves what a cell
measures. Two extensions, neither of which changes a draw of the random
stream (so the same seed gives the port's sequences):

  * each copy carries `tmap`, the template column of every copy base
    (-1 for a base a SNP inserted);
  * the PacBio error channel returns, beside the read, the index of the
    piece base each read base came from (-1 for an inserted base).

`sample_reads` chains both into each read's template column per base.
"""
from __future__ import annotations

from array import array
from dataclasses import dataclass

import numpy as np

# NotBase of DataSimulator.py:11: row = original base, col = int(U*3)
NOTBASE = np.array([[1, 2, 3], [0, 2, 3], [1, 0, 3], [1, 2, 0]], np.uint8)

# Drosophila read-length histogram, DataSimulator.py:126-127 (per kb)
LENGTHS_HISTO = np.array([
    0, 323, 427, 411, 355, 353, 358, 321, 293, 321, 281, 275, 241, 239,
    226, 185, 177, 162, 126, 117, 126, 108, 88, 83, 61, 52, 51, 29, 16,
    7, 3, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64)

# the PacBio channel of DataSimulator.py:12-27
P_KEEP = 0.837 + 0.115
P_SUB = 0.014
P_INS = 0.103139


@dataclass
class Copy:
    seq: bytearray        # codes 0-3
    tmap: array           # template column per base, -1 if inserted


def random_sequence(rng: np.random.Generator, length: int) -> np.ndarray:
    """DataSimulator.py:119-123."""
    return rng.integers(0, 4, length, dtype=np.int64).astype(np.uint8)


def pacbio_error(rng: np.random.Generator, seq: np.ndarray):
    """The error channel of DataSimulator.py:12-27, vectorised: keep
    w.p. .952, substitute w.p. .014, delete w.p. .034, then a geometric
    number of uniform insertions. Returns (read, src): src[j] is the
    index into seq of read base j, -1 for an inserted base."""
    seq = np.asarray(seq, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return seq.copy(), np.empty(0, np.int64)
    u = rng.random(n)
    keep = u < P_KEEP
    sub = (u >= P_KEEP) & (u < P_KEEP + P_SUB)
    emitted = np.where(sub, NOTBASE[seq, (rng.random(n) * 3).astype(
        np.int64)], seq)
    has_base = keep | sub
    ins = rng.geometric(1.0 - P_INS, n) - 1
    emit = has_base.astype(np.int64) + ins
    total = int(emit.sum())
    out = rng.integers(0, 4, total, dtype=np.int64).astype(np.uint8)
    starts = np.cumsum(emit) - emit
    out[starts[has_base]] = emitted[has_base]
    src = np.full(total, -1, np.int64)
    src[starts[has_base]] = np.flatnonzero(has_base)
    return out, src


def _mutate(rng: np.random.Generator, c: Copy, position: int) -> None:
    """One SNP drawn as DataSimulator.py:57-67 draws it: 1/3 each of
    substitution, deletion and insertion."""
    errortype = rng.random()
    rand = int(rng.random() * 3)
    if errortype <= 1.0 / 3.0:
        c.seq[position] = int(NOTBASE[c.seq[position], rand])
    elif errortype <= 2.0 / 3.0:
        del c.seq[position:position + 1]
        del c.tmap[position:position + 1]
    else:
        c.seq[position:position] = bytes([int(rng.random() * 4)])
        c.tmap[position:position] = array("l", [-1])


def tree_copies(rng, seq: np.ndarray, copynumber: int,
                difference: float) -> list[Copy]:
    """Binary doubling tree, DataSimulator.py:93-115: log2(n)+1
    generations, d/2 * len(seq) SNPs per branch, positions drawn in
    [0, len(parent) - SNPnumber)."""
    snps = int(difference / 2.0 * len(seq))
    gens = int(np.log2(copynumber)) + 1
    current = [Copy(bytearray(seq.tobytes()), array("l", range(len(seq))))]
    for _ in range(gens):
        nxt = []
        for old in current:
            parent_len = len(old.seq)
            for _c in range(2):
                c = Copy(bytearray(old.seq), array("l", old.tmap))
                for _t in range(snps):
                    _mutate(rng, c, int(rng.random() * (parent_len - snps)))
                nxt.append(c)
        current = nxt
    return current[:copynumber]


def distributed_copies(rng, seq: np.ndarray, copynumber: int,
                       difference: float) -> list[Copy]:
    """DistributedVarCopies, DataSimulator.py:29-49: 3*d*len(seq) SNPs,
    each applied to a random subset of the (shuffled) copies, positions
    processed high to low."""
    snps = int(len(seq) * difference * 3)
    copies = [Copy(bytearray(seq.tobytes()), array("l", range(len(seq))))
              for _ in range(copynumber)]
    positions = np.sort(10 + (rng.random(snps) *
                              (len(seq) - 20)).astype(np.int64))
    for t in range(snps):
        position = int(positions[snps - t - 1])
        order = rng.permutation(len(copies))
        copies = [copies[i] for i in order]
        rand = int(rng.random() * len(copies))
        errortype = rng.random()
        if errortype <= 1.0 / 3.0:
            for x in range(rand):
                copies[x].seq[position] = int(
                    NOTBASE[copies[x].seq[position], rand % 3])
        elif errortype <= 2.0 / 3.0:
            for x in range(rand):
                del copies[x].seq[position:position + 1]
                del copies[x].tmap[position:position + 1]
        else:
            base = bytes([int(rng.random() * 4)])
            for x in range(rand):
                copies[x].seq[position:position] = base
                copies[x].tmap[position:position] = array("l", [-1])
    return copies


STRUCTURES = {"Tree": tree_copies, "Distributed": distributed_copies}


@dataclass
class Read:
    seq: np.ndarray       # uint8 codes of the whole read
    cols: np.ndarray      # int64 template column per base, -1 otherwise
    repeat: np.ndarray    # bool: the base came from the copy's repeat part
    copy: int


def sample_reads(rng, genome: np.ndarray, tmap: np.ndarray, flank: int,
                 coverage: float, copy_id: int, plan=None) -> list[Read]:
    """DataSimulator.py:130-160: draw starts and lengths until the
    coverage of the repetitive part reaches `coverage`, then push each
    slice through the error channel, following every base back to its
    template column. plan: the generator of the starts and lengths
    (`rng` by default, as the simulator draws them)."""
    plan = rng if plan is None else plan
    probs = LENGTHS_HISTO / LENGTHS_HISTO.sum()
    glen = len(genome)
    starts, lengths = [], []
    covlen_sum = 0.0
    denom = float(glen - 2 * flank)
    while covlen_sum / denom < coverage:
        rand = plan.random()
        length = -1
        prob = 0.0
        while prob < rand:
            length += 1
            prob += probs[length]
        length = length * 1000 + int(plan.random() * 1000)
        start = int(plan.random() * (glen - length))
        lengths.append(length)
        starts.append(start)
        covlen_sum += (min(glen - flank, start + length) - max(start, flank))
    gidx = np.arange(glen)
    # genome index -> template column (-1 in the flanks and for copy
    # insertions)
    gcol = np.full(glen, -1, np.int64)
    gcol[flank:glen - flank] = tmap
    in_rep = np.zeros(glen, bool)
    in_rep[flank:glen - flank] = True
    reads = []
    for start, length in zip(starts, lengths):
        piece_idx = gidx[start:start + length]     # Python slice semantics
        read, src = pacbio_error(rng, genome[piece_idx])
        g = np.where(src >= 0, piece_idx[np.maximum(src, 0)], -1)
        cols = np.where(g >= 0, gcol[np.maximum(g, 0)], -1)
        rep = (g >= 0) & in_rep[np.maximum(g, 0)]
        reads.append(Read(read, cols, rep, copy_id))
    return reads


def simulate(structure: str, coverage: float, copynumber: int,
             difference: float, repeatlength: int, flank: int,
             seed: int, plan_seed: int | None = None):
    """DataSimulator's main path (DataSimulator.py:204-236): template,
    copies, flanks, reads. Returns (template, copies, reads). plan_seed:
    the reads' starts and lengths from a stream of their own (the same
    for every seed), not from the seed's."""
    rng = np.random.default_rng(seed)
    plan = None if plan_seed is None else np.random.default_rng(plan_seed)
    template = random_sequence(rng, repeatlength)
    copies = STRUCTURES[structure](rng, template, copynumber, difference)
    reads: list[Read] = []
    flanked = []
    for c in copies:
        left = random_sequence(rng, flank)
        right = random_sequence(rng, flank)
        flanked.append(np.concatenate(
            [left, np.frombuffer(bytes(c.seq), np.uint8), right]))
    for cid, (c, genome) in enumerate(zip(copies, flanked)):
        reads.extend(sample_reads(rng, genome,
                                  np.frombuffer(c.tmap, np.int64), flank,
                                  coverage, cid, plan))
    return template, copies, reads
