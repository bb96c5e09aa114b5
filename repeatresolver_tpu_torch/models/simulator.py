"""Simulated long-read data with ground truth.

Copied from repeatresolver_tpu/models/simulator.py (same functions, same bytes
written and read).

Re-architecture of the reference DataSimulator.py (cited per function):
same statistical model — PacBio-style error channel, three repeat-family
structures (Tree / Distributed / EquiDistant), Drosophila read-length
histogram — but vectorized numpy with an explicit seed (the reference
never seeds, so there is no golden stream to match; distributions are
matched instead).

Output files follow the exact on-disk contract (DataSimulator.py:241-262):
  <name>.fasta  <name>_ReadPlacements  <name>_ReadCopynumbers
  <name>_Template.fasta
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import SimulatorConfig
from ..utils import io as rio

# NotBase of DataSimulator.py:11 as a code table: row = original base,
# col = int(U*3). Note the non-sorted orders for g and t.
NOTBASE = np.array([
    [1, 2, 3],   # a -> c,g,t
    [0, 2, 3],   # c -> a,g,t
    [1, 0, 3],   # g -> c,a,t
    [1, 2, 0],   # t -> c,g,a
], dtype=np.uint8)

# Drosophila read-length histogram, DataSimulator.py:126-127 (per kb).
LENGTHS_HISTO = np.array([
    0, 323, 427, 411, 355, 353, 358, 321, 293, 321, 281, 275, 241, 239,
    226, 185, 177, 162, 126, 117, 126, 108, 88, 83, 61, 52, 51, 29, 16,
    7, 3, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64)


def random_sequence(rng: np.random.Generator, length: int) -> np.ndarray:
    """DataSimulator.py:119-123."""
    return rng.integers(0, 4, length, dtype=np.int64).astype(np.uint8)


def pacbio_error(rng: np.random.Generator, seq: np.ndarray,
                 cfg: SimulatorConfig) -> np.ndarray:
    """The error channel of DataSimulator.py:12-27, vectorized.

    Per base: keep w.p. .952, substitute w.p. .014 (NotBase[b][int(U*3)]),
    delete w.p. .034; then a geometric number of uniform insertions
    (continue prob .103139).
    """
    seq = np.asarray(seq, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return seq.copy()
    u = rng.random(n)
    keep = u < cfg.p_keep
    sub = (u >= cfg.p_keep) & (u < cfg.p_keep + cfg.p_sub)
    emitted_base = np.where(
        sub, NOTBASE[seq, (rng.random(n) * 3).astype(np.int64)], seq)
    has_base = keep | sub
    ins = rng.geometric(1.0 - cfg.p_ins, n) - 1
    emit = has_base.astype(np.int64) + ins
    total = int(emit.sum())
    # Inserted bases are uniform; prefill everything uniform, then place
    # the kept/substituted bases at each position's first slot.
    out = rng.integers(0, 4, total, dtype=np.int64).astype(np.uint8)
    ends = np.cumsum(emit)
    starts = ends - emit
    out[starts[has_base]] = emitted_base[has_base]
    return out


def _mutate(rng: np.random.Generator, copy: bytearray,
            position: int) -> None:
    """One SNP op drawn exactly like the generator loops
    (DataSimulator.py:57-67, 78-88, 101-111): 1/3 sub, 1/3 del, 1/3 ins."""
    errortype = rng.random()
    rand = int(rng.random() * 3)
    if errortype <= 1.0 / 3.0:  # Sub
        copy[position] = int(NOTBASE[copy[position], rand])
    elif errortype <= 2.0 / 3.0:  # Del
        del copy[position:position + 1]
    else:  # Ins
        base = int(rng.random() * 4)
        copy[position:position] = bytes([base])


def tree_copies(rng: np.random.Generator, seq: np.ndarray, copynumber: int,
                difference: float) -> list[np.ndarray]:
    """Binary doubling tree, DataSimulator.py:93-115: log2(n)+1 generations,
    d/2 * len(seq) SNPs per branch, positions drawn in
    [0, len(parent)-SNPnumber)."""
    snps = int(difference / 2.0 * len(seq))
    gens = int(np.log2(copynumber)) + 1
    current = [bytearray(seq.tobytes())]
    for _ in range(gens):
        nxt: list[bytearray] = []
        for oldcopy in current:
            parent_len = len(oldcopy)
            for _c in range(2):
                copy = bytearray(oldcopy)
                for _t in range(snps):
                    position = int(rng.random() * (parent_len - snps))
                    _mutate(rng, copy, position)
                nxt.append(copy)
        current = nxt
    return [np.frombuffer(bytes(c), dtype=np.uint8)
            for c in current[:copynumber]]


def gradient_copies(rng: np.random.Generator, seq: np.ndarray,
                    copynumber: int,
                    difference: float) -> list[np.ndarray]:
    """DataSimulator.py:52-69 (unused by the reference main, kept for
    parity of capability): each copy mutated from the PREVIOUS one with
    d * len(seq) SNPs — a linear divergence gradient."""
    snps = int(len(seq) * difference)
    out = [np.asarray(seq, np.uint8)]
    for _ in range(copynumber - 1):
        copy = bytearray(out[-1].tobytes())
        for _t in range(snps):
            position = int(rng.random() * len(copy))
            if position >= len(copy):
                continue
            _mutate(rng, copy, position)
        out.append(np.frombuffer(bytes(copy), dtype=np.uint8))
    return out


def equidistant_copies(rng: np.random.Generator, seq: np.ndarray,
                       copynumber: int,
                       difference: float) -> list[np.ndarray]:
    """DataSimulator.py:72-90: each copy mutated from the template with
    d/2 * len(seq) SNPs."""
    snps = int(difference / 2.0 * len(seq))
    out = []
    for _ in range(copynumber):
        copy = bytearray(seq.tobytes())
        for _t in range(snps):
            position = int(rng.random() * len(seq))
            if position >= len(copy):
                # The reference would IndexError on a sub here; requires
                # ~snps consecutive deletions at the end — unreachable in
                # practice. Skip like a del-at-end no-op.
                continue
            _mutate(rng, copy, position)
        out.append(np.frombuffer(bytes(copy), dtype=np.uint8))
    return out


def distributed_copies(rng: np.random.Generator, seq: np.ndarray,
                       copynumber: int,
                       difference: float) -> list[np.ndarray]:
    """DataSimulator.py:29-49: 3*d*len(seq) SNPs, each applied to a random
    subset of the (shuffled) copies, positions processed high-to-low."""
    snps = int(len(seq) * difference * 3)
    copies = [bytearray(seq.tobytes()) for _ in range(copynumber)]
    positions = np.sort(10 + (rng.random(snps) *
                              (len(seq) - 20)).astype(np.int64))
    for t in range(snps):
        position = int(positions[snps - t - 1])
        order = rng.permutation(len(copies))
        copies = [copies[i] for i in order]
        rand = int(rng.random() * len(copies))
        errortype = rng.random()
        if errortype <= 1.0 / 3.0:  # Sub on copies[:rand]
            for x in range(rand):
                copies[x][position] = int(
                    NOTBASE[copies[x][position], rand % 3])
        elif errortype <= 2.0 / 3.0:  # Del
            for x in range(rand):
                del copies[x][position:position + 1]
        else:  # Ins, one base shared by the subset
            base = bytes([int(rng.random() * 4)])
            for x in range(rand):
                copies[x][position:position] = base
    return [np.frombuffer(bytes(c), dtype=np.uint8) for c in copies]


STRUCTURES = {
    "Tree": tree_copies,
    "EquiDistant": equidistant_copies,
    "Distributed": distributed_copies,
    "Gradient": gradient_copies,
}


def read_sampling(rng: np.random.Generator, genome: np.ndarray,
                  cfg: SimulatorConfig) -> tuple[list[np.ndarray],
                                                 list[int]]:
    """DataSimulator.py:130-160: sample starts/lengths until the coverage
    of the repetitive part (positions flank..len-flank) reaches target,
    then push each slice through the error channel."""
    probs = LENGTHS_HISTO / LENGTHS_HISTO.sum()
    glen = len(genome)
    flank = cfg.flank
    starts: list[int] = []
    lengths: list[int] = []
    covlen_sum = 0.0
    denom = float(glen - 2 * flank)
    while covlen_sum / denom < cfg.coverage:
        rand = rng.random()
        length = -1
        prob = 0.0
        while prob < rand:
            length += 1
            prob += probs[length]
        length = length * 1000 + int(rng.random() * 1000)
        start = int(rng.random() * (glen - length))
        lengths.append(length)
        starts.append(start)
        # Repetitive-part overlap; may be negative (flank-only read) which
        # the reference happily subtracts (DataSimulator.py:150-152).
        covlen_sum += (min(glen - flank, start + length)
                       - max(start, flank))
    reads = []
    for start, length in zip(starts, lengths):
        # Python-slice semantics incl. negative starts, like the reference.
        piece = genome.tobytes()[start:start + length]
        reads.append(pacbio_error(
            rng, np.frombuffer(piece, dtype=np.uint8), cfg))
    return reads, starts


@dataclass
class SimulatedDataset:
    config: SimulatorConfig
    template: np.ndarray                 # uint8 codes, the repeat seq
    copies: list[np.ndarray]             # with flanks attached
    reads: list[np.ndarray]
    placements: np.ndarray               # int64 start per read
    copynumbers: np.ndarray              # int64 copy id per read

    @property
    def name(self) -> str:
        return self.config.dataset_name

    def write(self, directory: str | os.PathLike) -> dict[str, str]:
        d = os.fspath(directory)
        name = self.name
        paths = {
            "reads": os.path.join(d, name + ".fasta"),
            "placements": os.path.join(d, name + "_ReadPlacements"),
            "copynumbers": os.path.join(d, name + "_ReadCopynumbers"),
            "template": os.path.join(d, name + "_Template.fasta"),
        }
        rio.write_fasta(paths["reads"], self.reads, line_width=100)
        rio.write_ints(paths["placements"], self.placements)
        rio.write_ints(paths["copynumbers"], self.copynumbers)
        # Template is written unwrapped (DataSimulator.py:259-262).
        rio.write_fasta(paths["template"], [self.template], line_width=None)
        return paths


def simulate(cfg: SimulatorConfig) -> SimulatedDataset:
    """Full DataSimulator main path (DataSimulator.py:204-236)."""
    rng = np.random.default_rng(cfg.seed)
    template = random_sequence(rng, cfg.repeatlength)
    copies = STRUCTURES[cfg.structure](rng, template, cfg.copynumber,
                                       cfg.difference)
    flanked = []
    for c in copies:
        left = random_sequence(rng, cfg.flank)
        right = random_sequence(rng, cfg.flank)
        flanked.append(np.concatenate([left, c, right]))
    all_reads: list[np.ndarray] = []
    placements: list[int] = []
    copynumbers: list[int] = []
    for cidx, genome in enumerate(flanked):
        reads, starts = read_sampling(rng, genome, cfg)
        all_reads.extend(reads)
        placements.extend(starts)
        copynumbers.extend([cidx] * len(starts))
    return SimulatedDataset(
        config=cfg, template=template, copies=flanked, reads=all_reads,
        placements=np.array(placements, dtype=np.int64),
        copynumbers=np.array(copynumbers, dtype=np.int64))
