#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root; one GPU

Phases (each raises on failure, or when jax was imported, so any
failure exits non-zero):

  1. card and build: the card's name and power limit, torch / CUDA
     versions, and the nvcc build of both kernels from csrc/;
  2. kernels vs plain versions, small random blocks (gap-dense paths,
     rows of length 0 and 1), on the GPU: bit-equal codes, band, moves
     and (rows, best, iy, ib, inn);
  3. the same at the production dispatch shape (64 rows x 32,768 bases,
     band 1000, chunk 128, widen 6, MSA width 139,264), with the times
     and cells/s of each kernel and of its plain version;
  4. the main path: the runs/tpu_converge dataset (Tree, c=25, n=8,
     d=1%, l=4000, seed 11) built with the port's host stages, then the
     port's CLI `realign -b 1000 -B 64 --device cuda`. Its OverallScore
     sequence must equal column 2 of runs/tpu_converge/scorelog_tpu (all
     24 lines; the JAX package's trajectory, identical on TPU and CPU),
     and both kernels must have launched;
  5. kernels vs plain versions on the main path's own blocks: the fill
     inputs of the first block step at each slack (widen 12 first)
     recorded during phase 4, replayed through both kernels and their
     plain versions, bit-equal;
  6. the whole pipeline: the port's CLI `pipeline -c 40 -n 24 -d 1 -l
     4000 -t Tree --seed 11 -b 1000 -B 64 --device cuda` (615 MSA rows,
     so the MaxCorrs device scan's >= 512-row gate routes it to the
     card), with every resolver product sent to the card
     (RR_DEVICE_MM_MIN=0). The edit DP of cut and align, kernels A and
     B, the MaxCorrs scan and the resolver products must each have run
     on the card; cut and align must write the host native route's
     files byte for byte, MaxCorrs must make the host fast scan's
     decisions (within its tolerances), and one window's subdivisions
     must equal, byte for byte, a rerun with every product on the host.
     Prints each stage's seconds and the assessment;
  7. the MaxCorrs device scan at the paper run's size: a synthetic MSA
     of 13,833 rows x 131,072 columns from seed 0, a band of seed tiles
     scanned on the card and by the native host scan, same decisions
     within the same tolerances, with both times.

The second-to-last stdout line is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}. With no GPU, or without the
repository around it, the script fails before printing either.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
KERNELS = {
    "staircase_fill": dict(
        source="repeatresolver_tpu_torch/csrc/staircase_fill.cu",
        replaces="repeatresolver_tpu/ops/pallas_realign.py:358"),
    "walk_backtrack": dict(
        source="repeatresolver_tpu_torch/csrc/walk_backtrack.cu",
        replaces="repeatresolver_tpu/ops/pallas_backtrack.py:129"),
}


@contextlib.contextmanager
def phase(name):
    """Print a phase's header and, when it succeeds, its seconds. A phase
    fails if it imported jax: the port must run without it."""
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    if "jax" in sys.modules:
        raise AssertionError(f"phase {name} imported jax")
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def block_generator():
    """The CUDA kernel tests' random-block generator (numpy, from a
    seed: gap-dense paths, rows of length 0 and 1), loaded by path:
    other installed packages may shadow the top-level name `tests`."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_torch_cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("_cuda_kernel_tests",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._inputs


def compare_block(args, ncols, w, t, widen, cpad, timed=False):
    """Kernels A and B against their plain versions on one block of
    GPU tensors (counts, rows, seqs, ways, lengths), chained as a block
    step chains them; cpad is the width of the rewritten rows. Returns
    (max abs difference per kernel, times in ms or None)."""
    import torch

    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.ops import staircase_realign as sr

    counts, msa, seqs, ways, lengths = args
    b = msa.shape[0]
    dev = msa.device
    w2 = w + widen * t

    def timed_call(fn, reps):
        out = fn()
        if not timed:
            return out, None
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1]) / reps

    kw = dict(bandwidth=w, chunk=t, widen=widen)
    (ck, bk, ak), ms_a = timed_call(
        lambda: cr.staircase_fill(counts, msa, seqs, ways, lengths,
                                  ncols, **kw), 3)
    (cp, bp, ap), plain_a = timed_call(
        lambda: sr.staircase_fill(counts, msa, seqs, ways, lengths,
                                  ncols, **kw), 1)
    err_a = max(int((ck.long() - cp.long()).abs().max()),
                int((bk.long() - bp.long()).abs().max()),
                int((ak.long() - ap.long()).abs().max()))

    anf_full = sr.staircase_anf(ways, w, t)
    last_way = ways[torch.arange(b, device=dev),
                    (lengths - 1).clamp(min=0)]
    entry_bound = (last_way - w // 2).clamp(min=-1)
    wayin, best = cb.entry_scan(bk, ak, entry_bound, ncols, cpad=cpad,
                                bandwidth=w2)
    aint = anf_full[:, ::t].contiguous()
    mk, ms_b = timed_call(
        lambda: cb.backtrack_moves(ck, wayin, aint, lengths, chunk=t), 3)
    mp, plain_b = timed_call(
        lambda: cb.walk_plain(ck, wayin, aint, lengths, chunk=t), 1)
    err_b = int((mk.long() - mp.long()).abs().max())
    nw = ck.shape[0]
    seqs_p = torch.nn.functional.pad(seqs, (0, nw * 16 - seqs.shape[1]))
    out_k = cb.moves_to_outputs(mk, seqs_p, lengths, best, cpad=cpad)
    out_p = cb.moves_to_outputs(mp, seqs_p, lengths, best, cpad=cpad)
    for x, y in zip(out_k, out_p):      # rows, best, iy, ib, inn
        err_b = max(err_b, int((x.long() - y.long()).abs().max()))
    if err_a or err_b:
        raise AssertionError(f"kernel != plain version: fill max abs "
                             f"err {err_a}, walk max abs err {err_b}")
    return (err_a, err_b), (ms_a, plain_a, ms_b, plain_b)


def build_dataset(work):
    """runs/tpu_converge's dataset through the port's CLI (simulate,
    cut) and its initial aligner at align band 3000 (a setting the CLI
    does not expose)."""
    import numpy as np

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import InitialAlignerConfig
    from repeatresolver_tpu_torch.models import initial_aligner
    from repeatresolver_tpu_torch.utils import io as rio

    name = "Tree_1perc_4000kb"
    template = os.path.join(work, name + "_Template.fasta")
    cli.main(["simulate", "-c", "25", "-n", "8", "-d", "1", "-l", "4000",
              "-t", "Tree", "--seed", "11", "--outdir", work])
    cli.main(["cut", template, os.path.join(work, name + ".fasta"),
              "--device", "cpu"])
    d = rio.derived_paths(template)
    ia = initial_aligner.build_initial_msa(
        rio.read_template(template).astype(np.int16),
        [s.astype(np.int16) for s in rio.read_fasta(d["seq_fasta"])],
        InitialAlignerConfig(band=3000))
    initial_aligner.write_outputs(ia, d["msa"], d["seqclass"])
    return d["msa"]


class TimedLines(io.TextIOBase):
    """A stdout stand-in that keeps each printed line with the host
    time at which it was completed."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._part = ""

    def write(self, s):
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


PIPE_ARGS = ["-c", "40", "-n", "24", "-d", "1", "-l", "4000", "-t", "Tree",
             "--seed", "11"]
PIPE_NAME = "Tree_1perc_4000kb"


def pipeline_phase(card, dev):
    """Phase 6; returns the kernels' launches in the pipeline run."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch import cli
    from repeatresolver_tpu_torch.config import (MaxCorrConfig,
                                                 ResolverConfig,
                                                 WindowConfig)
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.models import resolver as pres
    from repeatresolver_tpu_torch.models.window import window_boundaries
    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_realign as cr
    from repeatresolver_tpu_torch.ops import devmm
    from repeatresolver_tpu_torch.ops import editdp
    from repeatresolver_tpu_torch.utils import io as rio

    pdir = os.path.join(WORK, "pipeline")
    hdir = os.path.join(WORK, "pipeline_host")
    os.makedirs(hdir)
    counters = [(cr.staircase_fill, "launches"),
                (cb.backtrack_moves, "launches"),
                (editdp.last_rows, "calls"), (editdp.align_on_device, "calls"),
                (pmc.compute_maxcorrs_device, "calls"),
                (devmm.matmul_t, "device_calls")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    # every resolver product to the card: at 615 rows no product reaches
    # the JAX package's 3e9-op gate
    os.environ["RR_DEVICE_MM_MIN"] = "0"
    out = TimedLines()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["pipeline"] + PIPE_ARGS + [
                "-b", "1000", "-B", "64", "-w", pdir, "--device", dev.type])
        torch.cuda.synchronize()
    finally:
        del os.environ["RR_DEVICE_MM_MIN"]
    fired = {f"{fn.__module__.split('.')[-1]}.{fn.__name__}":
             getattr(fn, attr) for fn, attr in counters}
    stage_s: dict = {}
    t_prev = t0
    for t, line in out.lines:
        print(f"  {line}")
        if line.startswith("["):
            stage = line[1:].split("]")[0].split()[0]
            stage_s[stage] = stage_s.get(stage, 0.0) + t - t_prev
            t_prev = t
    print(f"device routes fired in the pipeline run: {fired}")
    print("stage seconds (host clock, on " + card + "): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_s.items())
          + f"; total {t_prev - t0:.2f}")
    if min(fired.values()) <= 0:
        raise AssertionError(f"a device route never ran: {fired}")
    real_path = os.path.join(pdir, PIPE_NAME + "_MSAreal")
    real = rio.read_msa(real_path)
    print(f"MSAreal {real.shape}")
    if real.shape[0] < 512:
        raise AssertionError(f"{real.shape[0]} MSA rows: below the "
                             "MaxCorrs device gate of 512")

    # cut and align: the host native route on the same reads
    for suffix in ("_Template.fasta", ".fasta"):
        shutil.copy(os.path.join(pdir, PIPE_NAME + suffix), hdir)
    tpl = os.path.join(hdir, PIPE_NAME + "_Template.fasta")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["cut", tpl, os.path.join(hdir, PIPE_NAME + ".fasta"),
                  "--device", "cpu"])
        cli.main(["align", tpl, os.path.join(hdir, PIPE_NAME + "_Seq.fasta"),
                  "--device", "cpu"])
    for suffix in ("_Seq.fasta", "_ReadSeqInfo", "_MSA", "_SeqClass"):
        with open(os.path.join(pdir, PIPE_NAME + suffix), "rb") as f1, \
                open(os.path.join(hdir, PIPE_NAME + suffix), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{suffix}: device route != host "
                                     "native route")
    print(f"cut + align byte-equal to the host native route (band 0; "
          f"host route {time.perf_counter() - t1:.1f} s)")

    # MaxCorrs: the device scan again (it is deterministic: the same
    # file), against the host fast scan on the same MSAreal
    cfg = MaxCorrConfig()
    t1 = time.perf_counter()
    mc_d = pmc.compute_maxcorrs_device(real, cfg, device=dev)
    t_dev = time.perf_counter() - t1
    mc_file = os.path.join(hdir, "MaxCorrs_device")
    rio.write_maxcorrs(mc_file, mc_d)
    with open(mc_file, "rb") as f1, open(os.path.join(
            pdir, "MaxCorrsOf_" + PIPE_NAME + "_MSAreal"), "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("device scan not reproducible")
    t1 = time.perf_counter()
    mc_h = pmc.compute_maxcorrs(real, cfg, fast=True,
                                threads=os.cpu_count() or 1)
    t_host = time.perf_counter() - t1
    cutoff = cfg.resolved_cutoff(real.shape[1])
    sig = mc_h > cutoff
    if not np.array_equal(mc_d > cutoff, sig):
        raise AssertionError(f"MaxCorrs decisions differ at cutoff "
                             f"{cutoff}: {int(((mc_d > cutoff) != sig).sum())}")
    np.testing.assert_allclose(mc_d[sig], mc_h[sig], rtol=2e-3, atol=5e-3)
    dz = np.abs(mc_d - mc_h)
    print(f"MaxCorrs: {int(sig.sum())} significant of {len(mc_h)} at "
          f"cutoff {cutoff:.4f}, decisions identical; max|dZ| "
          f"{dz[sig].max() if sig.any() else 0.0:.3g} significant, "
          f"{dz.max():.3g} overall; device scan {t_dev:.2f} s, host fast "
          f"scan {t_host:.2f} s ({os.cpu_count()} threads) on {card}")

    # one window's subdivisions with every product on the host; the
    # window again with every product on the card, for its time
    von, bis = window_boundaries(real, WindowConfig())[:2]
    t1 = time.perf_counter()
    os.environ["RR_RESOLVER_DEVICE"] = "0"
    calls = devmm.matmul_t.device_calls
    try:
        res = pres.resolve_window(real, mc_d, von, bis, ResolverConfig(),
                                  dev)
    finally:
        del os.environ["RR_RESOLVER_DEVICE"]
    t_host = time.perf_counter() - t1
    if devmm.matmul_t.device_calls != calls:
        raise AssertionError("RR_RESOLVER_DEVICE=0 still used the card")
    os.environ["RR_DEVICE_MM_MIN"] = "0"
    t1 = time.perf_counter()
    try:
        pres.resolve_window(real, mc_d, von, bis, ResolverConfig(), dev)
        torch.cuda.synchronize()
    finally:
        del os.environ["RR_DEVICE_MM_MIN"]
    print(f"window {von}-{bis} resolve: {t_host:.2f} s with host "
          f"products, {time.perf_counter() - t1:.2f} s with "
          f"{devmm.matmul_t.device_calls - calls} products on {card}")
    for kind, u in res.items():
        name = rio.subdivision_path(kind, von, bis, PIPE_NAME + "_MSAreal")
        rio.write_subdivision(os.path.join(hdir, name), u)
        with open(os.path.join(pdir, name), "rb") as f1, \
                open(os.path.join(hdir, name), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{name}: device products != host")
    print(f"window {von}-{bis}: subdivisions byte-identical between "
          "RR_DEVICE_MM_MIN=0 and RR_RESOLVER_DEVICE=0")
    for _, line in out.lines:
        if line.startswith(("[realign]", "[assess")):
            print(f"{line}  ({card})")
    return {"staircase_fill": fired["cuda_realign.staircase_fill"],
            "walk_backtrack": fired["cuda_backtrack.backtrack_moves"]}


PAPER_ROWS, PAPER_COLS = 13833, 131072
PAPER_BAND_TILES = 8


def synthetic_msa(rows, cols, seed=0):
    """A MaxCorrs input at the paper run's size: 100 copy groups, 1% of
    columns planted SNPs (a block of copies carries a random other
    base), 2% noise and 3% gaps; each row covers one interval of
    20,000-60,000 columns (coverage gap 5 outside)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    copies = 100
    consensus = rng.integers(0, 4, cols).astype(np.int8)
    msa = np.empty((rows, cols), np.int8)
    msa[:] = consensus
    copy = rng.integers(0, copies, rows)
    for cc in rng.choice(cols, cols // 100, replace=False):
        first, size = rng.integers(0, copies), rng.integers(1, copies // 2)
        carriers = (copy - first) % copies < size
        msa[carriers, cc] = (consensus[cc] + rng.integers(1, 4)) % 4
    flat = msa.reshape(-1)
    pos = rng.integers(0, msa.size, msa.size // 50)
    flat[pos] = rng.integers(0, 4, pos.size).astype(np.int8)
    pos = rng.integers(0, msa.size, msa.size * 3 // 100)
    flat[pos] = 4
    del pos
    lens = rng.integers(20000, 60001, rows)
    starts = rng.integers(0, cols - lens + 1)
    for r in range(rows):
        msa[r, :starts[r]] = 5
        msa[r, starts[r] + lens[r]:] = 5
    return msa


def paper_scan_phase(card, dev):
    """Phase 7."""
    import numpy as np
    import torch

    from repeatresolver_tpu_torch.config import MaxCorrConfig
    from repeatresolver_tpu_torch.models import maxcorr as pmc
    from repeatresolver_tpu_torch.utils import native

    t0 = time.perf_counter()
    msa = synthetic_msa(PAPER_ROWS, PAPER_COLS)
    print(f"synthetic MSA {msa.shape} in {time.perf_counter() - t0:.1f} s")
    cfg = MaxCorrConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = pmc.MaxCorrScan(msa, cfg, 256, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    k0 = sc.nt // 2 - PAPER_BAND_TILES // 2
    band = range(k0, k0 + PAPER_BAND_TILES)
    t0 = time.perf_counter()
    acc = sc.scan(band)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    mc_d = acc[:PAPER_COLS * 5].cpu().numpy().astype(np.float64)
    peak = torch.cuda.max_memory_allocated() / 2**30
    i0, i1 = band.start * 256, band.stop * 256
    t0 = time.perf_counter()
    bits = native.MaxCorrBitsets(msa)
    t_bits = time.perf_counter() - t0
    mc_h = np.zeros(PAPER_COLS * 5, np.float64)
    t0 = time.perf_counter()
    bits.scan(mc_h, i0, i1, cfg.mincov, cfg.min_col_gap, PAPER_ROWS,
              cfg.majority_filter, True, os.cpu_count() or 1)
    t_host = time.perf_counter() - t0
    cutoff = cfg.resolved_cutoff(PAPER_COLS)
    sig = mc_h > cutoff
    if not np.array_equal(mc_d > cutoff, sig):
        raise AssertionError(f"decisions differ: "
                             f"{int(((mc_d > cutoff) != sig).sum())}")
    np.testing.assert_allclose(mc_d[sig], mc_h[sig], rtol=2e-3, atol=5e-3)
    dz = np.abs(mc_d - mc_h)
    print(f"seed columns [{i0}, {i1}) ({PAPER_BAND_TILES} tiles of 256): "
          f"{sc.tile_pairs} tile pairs, {int(sig.sum())} significant, "
          f"decisions identical, max|dZ| {dz[sig].max() if sig.any() else 0:.3g}"
          f" significant, {dz.max():.3g} overall")
    print(f"device: one-hot build {t_build:.2f} s, band {t_dev:.2f} s, "
          f"{t_dev / max(sc.tile_pairs, 1) * 1e3:.3f} ms per tile pair, "
          f"peak {peak:.2f} GiB; host native scan {t_host:.2f} s "
          f"({os.cpu_count()} threads; bitsets {t_bits:.1f} s) on {card}")
    if sig.sum() == 0:
        raise AssertionError("no significant MaxCorrs in the band")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from repeatresolver_tpu_torch.models import realigner as prt
    from repeatresolver_tpu_torch.models import realigner_device as prd
    from repeatresolver_tpu_torch.ops import _build
    from repeatresolver_tpu_torch.ops import cuda_backtrack as cb
    from repeatresolver_tpu_torch.ops import cuda_realign as cr

    from repeatresolver_tpu_torch.models.realigner_device import \
        DEFAULT_WIDEN

    dev = torch.device("cuda", 0)
    errs = {k: 0 for k in KERNELS}

    def to_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]
    with phase("1 card and build"):
        # phase 7's scan runs the native library: build it (g++) now
        from repeatresolver_tpu_torch.utils import native
        if native.get_lib() is None:
            raise RuntimeError("native host library did not build")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} "
              f"device {torch.cuda.get_device_name(0)}")
        for name in KERNELS:
            _build.load(name)
            secs, log = _build.build_info.get(name, (0.0, "cached"))
            print(f"built {name} in {secs:.1f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    with phase("2 kernels vs plain, small blocks"):
        cases = [dict(seed=5), dict(seed=7, gapdense=True),
                 dict(seed=11, gapdense=True, len_lo=0.05),
                 dict(seed=3, zero_rows=(2, 5))]
        block_inputs = block_generator()
        for case in cases:
            args = to_dev(block_inputs(b=8, tlen=256, c=512, **case))
            for widen in (1, 3):
                (ea, eb), _ = compare_block(args, 512, 64, 32, widen, 576)
                errs["staircase_fill"] = max(errs["staircase_fill"], ea)
                errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
        print(f"{len(cases) * 2} blocks bit-equal (rows of length 0 and "
              "1, dead walks included)")

    with phase("3 kernels vs plain, production shape"):
        import numpy as np
        b, l, w, c, t, widen = 64, 32768, 1000, 139264, 128, 6
        rng = np.random.default_rng(0)
        msa = rng.integers(0, 4, (b, c)).astype(np.int8)
        counts = np.stack([(msa == s).sum(axis=0) for s in range(6)],
                          axis=1).astype(np.int32)
        counts[:, 0] += 40
        seqs = rng.integers(0, 4, (b, l)).astype(np.int8)
        ways = np.broadcast_to(np.linspace(0, c - 1, l).astype(np.int32),
                               (b, l)).copy()
        lengths = np.full(b, l, np.int32)
        (ea, eb), (ms_a, plain_a, ms_b, plain_b) = compare_block(
            to_dev((counts, msa, seqs, ways, lengths)), c, w, t, widen,
            c + 64, timed=True)
        errs["staircase_fill"] = max(errs["staircase_fill"], ea)
        errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
        cells = b * l * w
        times = {"staircase_fill": (ms_a, plain_a),
                 "walk_backtrack": (ms_b, plain_b)}
        for name, (ms, pms) in times.items():
            print(f"{name}: kernel {ms:.3f} ms ({cells / ms * 1e3:.4g} "
                  f"cells/s), plain {pms:.3f} ms "
                  f"({cells / pms * 1e3:.4g} cells/s) on {card}")
        print("bit-equal at 64 x 32768, band 1000, chunk 128, widen 6")

    with phase("4 main path: CLI realign on the tpu_converge dataset"):
        from repeatresolver_tpu_torch import cli
        from repeatresolver_tpu_torch.utils import io as rio
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        t0 = time.perf_counter()
        msa_path = build_dataset(WORK)
        msa = rio.read_msa(msa_path)
        print(f"host stages (simulate, cut, align): "
              f"{time.perf_counter() - t0:.1f} s, MSA {msa.shape}")
        if msa.shape != (131, 85628):
            raise AssertionError(f"MSA shape {msa.shape} != (131, 85628)")
        out_path = os.path.join(WORK, "MSAreal")
        cr.staircase_fill.launches = 0
        cb.backtrack_moves.launches = 0
        prt.BatchedRealigner.host_sweeps = 0
        prt.BatchedRealigner.host_sweep_s = 0.0
        prd.DeviceResidentRealigner.exact_blocks_run = 0
        prd.DeviceResidentRealigner.resident_sweep_s = 0.0
        # record the fill inputs of the first block step at each slack
        # (clones: the resident MSA is rewritten in place) for phase 5;
        # the block step reaches the fill through this stand-in module
        blocks = {}

        def recording_fill(*args, **kw):
            if kw["widen"] not in blocks and len(blocks) < 4:
                blocks[kw["widen"]] = ([a.clone() for a in args[:5]],
                                       args[5], kw)
            return cr.staircase_fill(*args, **kw)

        buf = io.StringIO()
        prd.cr = types.SimpleNamespace(staircase_fill=recording_fill)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["realign", msa_path, "-o", out_path, "-b",
                          "1000", "-B", "64", "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            prd.cr = cr
        wall = time.perf_counter() - t0
        launches = {"staircase_fill": cr.staircase_fill.launches,
                    "walk_backtrack": cb.backtrack_moves.launches}
        scores = [ln.split()[1] for ln in buf.getvalue().splitlines()
                  if ln.startswith("OverallScore:")]
        with open(os.path.join(REPO, "runs", "tpu_converge",
                               "scorelog_tpu")) as f:
            oracle = [ln.split()[1] for ln in f if ln.strip()]
        real = rio.read_msa(out_path)
        bases = int((msa < 4).sum())
        rounds = len(scores) - 2
        cells = rounds * bases * 1000
        print(f"realign: {len(scores)} OverallScore lines, best "
              f"{min(scores)}, {rounds} rounds, wall {wall:.2f} s, "
              f"{cells / wall:.4g} cells/s on {card}")
        print(f"launches {launches}, exact-fallback blocks "
              f"{prd.DeviceResidentRealigner.exact_blocks_run}, host "
              f"anneal-tail rounds {prt.BatchedRealigner.host_sweeps}")
        res_s = prd.DeviceResidentRealigner.resident_sweep_s
        host_s = prt.BatchedRealigner.host_sweep_s
        print(f"seconds: resident sweeps {res_s:.2f}, host anneal-tail "
              f"sweeps {host_s:.2f}, rest of the loop "
              f"{wall - res_s - host_s:.2f}")
        if scores != oracle:
            raise AssertionError(f"score trajectory {scores} != "
                                 f"scorelog_tpu {oracle}")
        prt.validate_counts(real, prt.symbol_counts(real))
        best = min((int(s[:-6] or 0), int(s[-6:])) for s in scores)
        if prt.overall_score_pair(prt.symbol_counts(real)) != best:
            raise AssertionError("MSAreal does not score the best pair")
        for k in range(msa.shape[0]):
            if not np.array_equal(msa[k][msa[k] < 4], real[k][real[k] < 4]):
                raise AssertionError(f"row {k} lost or changed bases")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel never launched: {launches}")

    with phase("5 kernels vs plain on the main path's own blocks"):
        for widen, (args, ncols, kw) in blocks.items():
            (ea, eb), _ = compare_block(args, ncols, kw["bandwidth"],
                                        kw["chunk"], widen,
                                        args[1].shape[1])
            errs["staircase_fill"] = max(errs["staircase_fill"], ea)
            errs["walk_backtrack"] = max(errs["walk_backtrack"], eb)
            b, lpad = args[2].shape
            print(f"bit-equal: {b} rows x {lpad} bases, MSA width {ncols}"
                  f" of {args[1].shape[1]}, band {kw['bandwidth']}, chunk"
                  f" {kw['chunk']}, widen {widen} "
                  f"(W2 {kw['bandwidth'] + widen * kw['chunk']})")
        if DEFAULT_WIDEN not in blocks:
            raise AssertionError(f"no block step at widen {DEFAULT_WIDEN}"
                                 f" recorded: {sorted(blocks)}")

    with phase("6 main path: CLI pipeline on the card"):
        pipe_launches = pipeline_phase(card, dev)

    with phase("7 MaxCorrs scan at paper width"):
        paper_scan_phase(card, dev)

    report = [dict(name=name, route="cuda", **KERNELS[name],
                   launches=launches[name],
                   pipeline_launches=pipe_launches[name],
                   max_abs_err=errs[name], ms=times[name][0],
                   plain_ms=times[name][1])
              for name in KERNELS]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
