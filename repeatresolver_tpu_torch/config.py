"""Typed configuration covering the reference's whole flag surface.

Copied from repeatresolver_tpu/config.py (same dataclasses, same
defaults).

Defaults mirror the reference tools (see SURVEY.md §2.5):
  DataSimulator.py:164-168,223-224  ReadCutter.c:985-988
  InitialAligner.c:705-706,750      PW_ReAligner.c:1619,1625-1626
  MaxCorrelation.c:925-930,998,804  RepeatResolver.c:3872-3977,4017-4036
  Window.py:32-33
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


def _py2_float_str(x: float) -> str:
    """Python 2 str(float): 12 significant digits, always with a '.'."""
    s = f"{x:.12g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s


@dataclass(frozen=True)
class SimulatorConfig:
    """DataSimulator.py:164-182 flag surface."""
    coverage: int = 40                 # -c
    copynumber: int = 100              # -n
    difference: float = 0.01           # -d (fraction, flag is in percent)
    repeatlength: int = 30000          # -l
    structure: str = "Tree"            # -t: Tree | Distributed | EquiDistant
    flank: int = 10000                 # DataSimulator.py:223-224
    # PacBio error model, DataSimulator.py:12-27
    p_keep: float = 0.837 + 0.115      # match branch of the first draw
    p_sub: float = 0.014
    p_del: float = 0.034
    p_ins: float = 0.103139            # geometric insertion continue prob
    seed: int = 0

    @property
    def dataset_name(self) -> str:
        """Name contract of DataSimulator.py:189-198 (note 'kb' literal)."""
        percstring = _py2_float_str(self.difference * 100.0)
        i = len(percstring) - 1
        while percstring[i] == "0":
            percstring = percstring[:i]
            i -= 1
        if percstring[i] == ".":
            percstring = percstring[:i]
        return (f"{self.structure}_{percstring.replace('.', '')}perc_"
                f"{self.repeatlength}kb")


@dataclass(frozen=True)
class ReadCutterConfig:
    """ReadCutter.c:985-988."""
    parts: int = 60            # -p
    overlap: int = 0           # -l
    error_cutoff: float = 0.30 # -e
    wiggleroom: int = 150      # -w  (only affects diagnostics histograms)


@dataclass(frozen=True)
class InitialAlignerConfig:
    """InitialAligner.c:705-706,750."""
    error_cutoff: float = 0.30  # -e
    max_read_length: int = 40000
    # Extension (no reference equivalent): band the glocal DP around the length-scaled
    # diagonal (0 = reference full matrix). Validated against full DP —
    # near-diagonal repeat pieces get identical alignments; only
    # already-garbage (class 'l') alignments can differ.
    band: int = 0


@dataclass(frozen=True)
class RealignerConfig:
    """PW_ReAligner.c:1619,1625-1626 plus the batching knobs."""
    bandwidth: int = 1000      # -b (half band = bandwidth//2)
    max_rounds: int = 10000    # PW_ReAligner.c:1681
    # Extensions (no reference equivalent):
    block_rows: int = 1        # rows realigned per Jacobi block; 1 == exact
                               # Gauss-Seidel reference trajectory
    mode: str = "auto"         # auto (the staircase; the exact band with
                               # kernel native) |
                               # "exact" reference band | "staircase"
                               # chunked band (turbo; ops/staircase_realign)
    kernel: str = "auto"       # auto (the hand-written kernels for the
                               # staircase; for the exact band torch on
                               # a GPU, native on the CPU) |
                               # torch (plain torch ops) | cuda (kernels
                               # A and B, staircase) |
                               # native (C++ host kernel, exact mode)
    checkpoint_every_round: bool = True  # best-MSA persistence semantics of
                               # PW_ReAligner.c:1741
    mesh_devices: int = 0      # >1: shard each block's rows over the
                               # ranks of a process group
                               # (parallel/sharded.py); trajectory
                               # bit-equal to single-process


@dataclass(frozen=True)
class MaxCorrConfig:
    """MaxCorrelation.c:925-930, 998, 804, 597."""
    mincov: int = 30           # -c  (shared-coverage early-stop + size gate)
    min_col_gap: int = 20      # MaxCorrelation.c:804 (pairs >= 20 cols apart)
    cutoff: float | None = None  # None -> -log10(1/(5*siglength))
    majority_filter: bool = True # threaded-variant seed filter,
                                 # MaxCorrelation.c:802 (the default path)

    def resolved_cutoff(self, siglength: int) -> float:
        if self.cutoff is not None:
            return self.cutoff
        return -math.log10(1.0 / (siglength * 5.0))


@dataclass(frozen=True)
class ResolverConfig:
    """RepeatResolver.c:3872-3977, 4017-4036."""
    cov: int = 30                # -c -> mincov
    cutoff: float = 0.0          # -t; <0.1 -> -log10(1/(5*siglength))
    maxclique: int = 30          # RepeatResolver.c:4021
    sizecutoff: int = -1         # RepeatResolver.c:4027
    dropoffcutoff: float = 0.0001  # RepeatResolver.c:4036
    min_clique_size: int = 5     # Sizes[i] > 5 gate, RepeatResolver.c:1659
    coverage_keep_frac: float = 0.9  # kill cols with cov*10 < maxcov*9

    @property
    def mingroup(self) -> int:
        return self.cov // 2      # RepeatResolver.c:4028

    def resolved_cutoff(self, siglength: int) -> float:
        if self.cutoff >= 0.1:
            return self.cutoff
        return -math.log10(1.0 / (siglength * 5.0))


@dataclass(frozen=True)
class WindowConfig:
    """Window.py:32-33."""
    coverage: float = 0.90  # -c
    parts: int = 6          # -p


@dataclass(frozen=True)
class PipelineConfig:
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    read_cutter: ReadCutterConfig = field(default_factory=ReadCutterConfig)
    initial_aligner: InitialAlignerConfig = field(
        default_factory=InitialAlignerConfig)
    realigner: RealignerConfig = field(default_factory=RealignerConfig)
    maxcorr: MaxCorrConfig = field(default_factory=MaxCorrConfig)
    resolver: ResolverConfig = field(default_factory=ResolverConfig)
    window: WindowConfig = field(default_factory=WindowConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def small_sim() -> PipelineConfig:
    """The CPU-runnable small config from BASELINE.json."""
    return PipelineConfig(
        simulator=SimulatorConfig(coverage=30, copynumber=10,
                                  repeatlength=5000))


def paper_default() -> PipelineConfig:
    """Tree_1perc_30000kb, c=40, n=100 (BASELINE.md north star)."""
    return PipelineConfig()
