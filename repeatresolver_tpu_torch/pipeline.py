"""End-to-end pipeline driver.

Counterpart of repeatresolver_tpu/pipeline.py: simulate -> cut ->
initial MSA -> realign -> window -> MaxCorrs -> per-window clustering
-> assessment, with the reference's file contract at every stage and
the JAX driver's printed lines. Each stage takes the route the JAX
package takes on its backend, keyed here on the caller's `device`:

  cut, align  device "cuda": the edit DP on the card (ops/editdp);
              "cpu": the native host kernels
  realign     realign_batched on `device` (kernels A and B on "cuda")
  MaxCorrs    the device scan on "cuda" at >= 512 rows and > 4M cells
              (the JAX package's gate, maxcorr.compute_maxcorrs_routed,
              shared with the paper driver); the host fast path otherwise
  resolve     the exact products above the devmm gate on `device`

No stage falls back to the host when its device route fails.
"""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .config import PipelineConfig
from .device import resolve_device
from .models import (assessment, initial_aligner, maxcorr, read_cutter,
                     realigner, resolver, simulator, window)
from .utils import io as rio
from .utils.hostmem import tune_allocator


@dataclass
class PipelineResult:
    workdir: str
    name: str
    paths: dict = field(default_factory=dict)
    boundaries: list = field(default_factory=list)
    window_results: dict = field(default_factory=dict)
    quality: dict = field(default_factory=dict)


@contextlib.contextmanager
def trace(profile_dir: str | None, dev, filename: str):
    """A torch.profiler trace (CPU, and CUDA on a CUDA device) of the
    block, written to profile_dir/filename in Chrome trace format; no
    profiler when profile_dir is None."""
    if not profile_dir:
        yield
        return
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, filename))


def run_pipeline(cfg: PipelineConfig, workdir: str, progress=print,
                 profile_dir: str | None = None,
                 device="cuda") -> PipelineResult:
    """profile_dir: when set, a torch.profiler trace of the realign
    phase is written there as realign_trace.json (Chrome trace
    format).

    cfg.realigner.mesh_devices > 1 (with block_rows > 1) shards the
    realign blocks over the process group this process has joined
    (parallel/sharded.make_mesh, which raises unless the group has that
    many ranks). Every rank runs the whole pipeline: rank 0 in workdir,
    rank r in workdir/rank<r>; on a mesh the realign stage writes its
    files on rank 0 only."""
    dev = resolve_device(device)
    mesh = None
    if cfg.realigner.block_rows > 1 and cfg.realigner.mesh_devices > 1:
        from .parallel import sharded
        mesh = sharded.make_mesh(cfg.realigner.mesh_devices, device=dev)
        if mesh.rank:
            # every rank runs the (deterministic) stages on files of its
            # own; rank 0's are the run's result
            workdir = os.path.join(workdir, f"rank{mesh.rank}")
    tune_allocator()
    os.makedirs(workdir, exist_ok=True)
    ds = simulator.simulate(cfg.simulator)
    paths = ds.write(workdir)
    name = ds.name
    res = PipelineResult(workdir=workdir, name=name, paths=paths)
    progress(f"[sim] {len(ds.reads)} reads, template "
             f"{len(ds.template)}")

    template = ds.template.astype(np.int16)
    reads = [r.astype(np.int16) for r in ds.reads]
    cut = read_cutter.cut_reads(template, reads, cfg.read_cutter, dev)
    seq_path = os.path.join(workdir, name + "_Seq.fasta")
    info_path = os.path.join(workdir, name + "_ReadSeqInfo")
    rio.write_fasta(seq_path, cut.pieces, line_width=None)
    rio.write_readseqinfo(info_path, cut.seqs_per_read)
    paths["seq_fasta"], paths["readseqinfo"] = seq_path, info_path
    progress(f"[cut] {len(cut.pieces)} pieces")

    seqs = [p.astype(np.int16) for p in cut.pieces]
    ia = initial_aligner.build_initial_msa(template, seqs,
                                           cfg.initial_aligner, dev)
    msa_path = os.path.join(workdir, name + "_MSA")
    sc_path = os.path.join(workdir, name + "_SeqClass")
    initial_aligner.write_outputs(ia, msa_path, sc_path)
    paths["msa"], paths["seqclass"] = msa_path, sc_path
    progress(f"[align] {len(ia.rows)} repeat rows, "
             f"width {len(ia.rows[0]) if ia.rows else 0}")

    msa = rio.read_msa(msa_path)
    msareal_path = os.path.join(workdir, name + "_MSAreal")
    log: list = []
    rstats: dict = {}
    with trace(profile_dir, dev, "realign_trace.json"):
        best = realigner.realign_batched(
            msa, cfg.realigner, out_path=msareal_path, score_log=log,
            checkpoint_path=os.path.join(workdir, name + "_realign.ckpt"),
            stats=rstats, mode=cfg.realigner.mode,
            kernel=cfg.realigner.kernel, mesh=mesh,
            device=dev)
    if mesh is not None and mesh.rank:
        rio.write_msa(msareal_path, best, upper=True)
    paths["msareal"] = msareal_path
    progress(f"[realign] {len(log) - 1} rounds, score "
             f"{log[0]} -> {log[-1]}, width {best.shape[1]}"
             + (f", {rstats.get('cells_per_s', 0):.2e} cells/s"
                if rstats else ""))

    msareal = rio.read_msa(msareal_path)
    bounds = window.window_boundaries(msareal, cfg.window)
    res.boundaries = bounds
    progress(f"[window] boundaries {bounds}")

    mc = maxcorr.compute_maxcorrs_routed(
        msareal, cfg.maxcorr, dev, threads=min(4, os.cpu_count() or 1))
    mc_path = os.path.join(workdir,
                           "MaxCorrsOf_" + os.path.basename(msareal_path))
    rio.write_maxcorrs(mc_path, mc)
    paths["maxcorrs"] = mc_path
    progress(f"[maxcorr] {int((mc > 0).sum())} nonzero of {len(mc)}")

    # windows are independent (the reference's operator-level
    # parallelism, Window.py + README.md:104-106): resolve concurrently
    windows = list(zip(bounds[:-1], bounds[1:]))

    def resolve_one(vb):
        von, bis = vb
        return vb, resolver.resolve_window(msareal, mc, von, bis,
                                           cfg.resolver, dev)

    with ThreadPoolExecutor(max_workers=min(4, len(windows))) as ex:
        for (von, bis), out in ex.map(resolve_one, windows):
            for kind, u in out.items():
                p = os.path.join(workdir, rio.subdivision_path(
                    kind, von, bis, os.path.basename(msareal_path)))
                rio.write_subdivision(p, u)
            res.window_results[(von, bis)] = out
            nclusters = int(out["Kmeans"].max()) + 1
            progress(f"[resolve {von}-{bis}] {nclusters} kmeans "
                     f"clusters")

    # the assessment needs seq2read restricted to the MSAreal rows
    sd = assessment.SimDataset.load(workdir)
    gt = sd.ground_truth_resolution()
    singles = {}
    for (von, bis), out in res.window_results.items():
        q = assessment.resolution_quality(gt, out["Kmeans"])
        singles[(von, bis)] = q
        progress(f"[assess {von}-{bis}] tp={q.truepositives} "
                 f"fp={q.falsepositives}")
    res.quality["singles"] = singles
    if len(res.window_results) >= 1:
        left, right = sd.flanking()
        ordered = [res.window_results[k]["Kmeans"]
                   for k in sorted(res.window_results)]
        _, multi = assessment.multi_step_resolution(left, ordered, right)
        res.quality["multi"] = multi
        progress(f"[assess multi] tp={multi.truepositives} "
                 f"fp={multi.falsepositives} of "
                 f"{len(np.unique(gt))} copies")
    return res
