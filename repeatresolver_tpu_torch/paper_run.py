"""Paper-default pipeline driver with stage resume.

Counterpart of scripts/paper_run.py. Runs the paper's default
configuration (Tree, d=1%, l=30000, n=100, c=40, seed 0) end to end
with the reference tools' file contract, so every stage resumes from its
files on disk:

  * a stage is skipped when its output exists (the reference's own
    caching: MaxCorrs are computed once and reloaded,
    MaxCorrelation.c:1014 / RepeatResolver.c:3972); each window's
    resolve is skipped when its three subdivision files exist;
  * realign writes the best MSA and a binary checkpoint every improving
    round (PW_ReAligner.c:1741) and resumes from the checkpoint;
  * each stage appends its wall time and extras to
    <workdir>/stage_times.json; --until stops after a stage.

    python -m repeatresolver_tpu_torch.paper_run --workdir DIR
        [--until STAGE] [--device cuda|cpu] [flags]

Routes, keyed on --device (default cuda, which raises where torch sees
no GPU; nothing falls back to the CPU):

  cpu   the JAX driver's host routes, so its files are byte-equal to
        scripts/paper_run.py's: native cut and align (--align-band
        applies), the exact band on the host native engine, the host
        MaxCorrs fast scan (--threads, with its checkpoint), resolve on
        the host;
  cuda  each stage's route in run_pipeline(device="cuda"): cut and
        align through kernels C and D (the full edit DP: --align-band
        is ignored, as the JAX package's device route has no band), the
        resident realign engine (kernels A and B; the host native
        anneal tail below RESIDENT_MIN_BS), MaxCorrs through
        maxcorr.compute_maxcorrs_routed (the device scan at the sizes
        its gate names), resolve with the exact products on the card.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import time

import numpy as np

STAGES = ["simulate", "cut", "align", "realign", "window", "maxcorr",
          "resolve", "assess"]


def log_stage(workdir, stage, dt, extra=None):
    rec = {"stage": stage, "wall_s": round(dt, 2),
           "ts": time.strftime("%H:%M:%S")}
    if extra:
        rec.update(extra)
    with open(os.path.join(workdir, "stage_times.json"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[{rec['ts']}] {stage}: {dt:.1f}s {extra or ''}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags and defaults, and --device; --workdir has
    no default (the JAX driver's, runs/paper, holds its committed
    reference run)."""
    ap = argparse.ArgumentParser(
        prog="python -m repeatresolver_tpu_torch.paper_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("-c", type=int, default=40)
    ap.add_argument("-n", type=int, default=100)
    ap.add_argument("-d", type=float, default=1.0)
    ap.add_argument("-l", type=int, default=30000)
    ap.add_argument("-t", default="Tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--band", type=int, default=1000)
    ap.add_argument("--block-rows", type=int, default=64)
    ap.add_argument("--align-band", type=int, default=5000,
                    help="banded initial alignment (0 = full DP); "
                    "--device cpu only: the card aligns with the full DP")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--resolver-cov", type=int, default=0,
                    help="0 = auto from in-window kept rows / n")
    ap.add_argument("--until", default="assess", choices=STAGES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the kernels; raises without a GPU) or "
                    "cpu (the host routes)")
    return ap


def sim_config(args):
    from .config import SimulatorConfig
    return SimulatorConfig(coverage=args.c, copynumber=args.n,
                           difference=args.d / 100.0, repeatlength=args.l,
                           structure=args.t, seed=args.seed)


def files(workdir: str, name: str) -> dict:
    """The driver's files, by key."""
    p = os.path.join(workdir, name)
    return {"template": p + "_Template.fasta", "reads": p + ".fasta",
            "seq": p + "_Seq.fasta", "info": p + "_ReadSeqInfo",
            "msa": p + "_MSA", "seqclass": p + "_SeqClass",
            "msareal": p + "_MSAreal", "done": p + "_MSAreal.done",
            "ckpt": p + "_realign.ckpt", "scorelog": p + "_scorelog",
            "maxcorrs": os.path.join(workdir,
                                     "MaxCorrsOf_" + name + "_MSAreal"),
            "stage_times": os.path.join(workdir, "stage_times.json"),
            "assessment": os.path.join(workdir, "assessment.json")}


# a stage is skipped when this file of it exists; window, resolve (each
# window on its own subdivision files) and assess always run
SKIP_IF = {"simulate": "reads", "cut": "seq", "align": "msa",
           "realign": "done", "maxcorr": "maxcorrs"}


def subdivision_files(msareal_path: str, von: int, bis: int) -> dict:
    """A window's three subdivision files, by kind."""
    from .utils import io as rio
    return {k: os.path.join(os.path.dirname(msareal_path),
                            rio.subdivision_path(
                                k, von, bis, os.path.basename(msareal_path)))
            for k in ("Dropoff", "RelDrop", "Kmeans")}


def windows(msareal) -> list:
    from . import config as C
    from .models import window
    bounds = window.window_boundaries(msareal, C.WindowConfig())
    print(f"windows: {bounds}", flush=True)
    return list(zip(bounds[:-1], bounds[1:]))


def maxcorrs(msareal, args, dev, checkpoint_path=None):
    """The maxcorr stage's scan (the device scan at the sizes its gate
    names)."""
    from . import config as C
    from .models import maxcorr
    return maxcorr.compute_maxcorrs_routed(
        msareal, C.MaxCorrConfig(), dev, threads=args.threads,
        checkpoint_path=checkpoint_path)


def resolve(msareal, mc, von, bis, args, dev):
    """One window's resolve; returns (its subdivisions, the coverage):
    --resolver-cov, or at 0 the rows kept at both ends over n."""
    from . import config as C
    from .models import resolver
    cov = args.resolver_cov
    if cov == 0:
        keep = (msareal[:, von] < 5) & (msareal[:, bis] < 5)
        cov = max(4, int(keep.sum()) // args.n)
    return resolver.resolve_window(msareal, mc, von, bis,
                                   C.ResolverConfig(cov=cov), dev), cov


def main(argv=None):
    # periodic all-thread stack dumps to stderr: a wedged stage looks
    # like a silent hang otherwise
    faulthandler.dump_traceback_later(900, repeat=True)
    try:
        _run(build_parser().parse_args(argv))
    finally:
        faulthandler.cancel_dump_traceback_later()


def _run(args):
    from . import config as C
    from .device import resolve_device
    from .utils import io as rio
    from .utils.hostmem import tune_allocator

    dev = resolve_device(args.device)
    tune_allocator()
    workdir = args.workdir
    os.makedirs(workdir, exist_ok=True)
    until = STAGES.index(args.until)
    sim_cfg = sim_config(args)
    f = files(workdir, sim_cfg.dataset_name)

    def skip(stage):
        return os.path.exists(f[SKIP_IF[stage]])

    # ---- 1 simulate
    if not skip("simulate"):
        t0 = time.perf_counter()
        from .models import simulator
        ds = simulator.simulate(sim_cfg)
        ds.write(workdir)
        log_stage(workdir, "simulate", time.perf_counter() - t0,
                  {"reads": len(ds.reads)})
    if until < 1:
        return

    # ---- 2 cut
    if not skip("cut"):
        t0 = time.perf_counter()
        from .models import read_cutter
        template = rio.read_template(f["template"]).astype(np.int16)
        reads = [r.astype(np.int16) for r in rio.read_fasta(f["reads"])]
        cut = read_cutter.cut_reads(template, reads, C.ReadCutterConfig(),
                                    dev)
        rio.write_fasta(f["seq"], cut.pieces, line_width=None)
        rio.write_readseqinfo(f["info"], cut.seqs_per_read)
        log_stage(workdir, "cut", time.perf_counter() - t0,
                  {"pieces": len(cut.pieces)})
    if until < 2:
        return

    # ---- 3 align
    if not skip("align"):
        t0 = time.perf_counter()
        from .models import initial_aligner
        template = rio.read_template(f["template"]).astype(np.int16)
        seqs = [s.astype(np.int16) for s in rio.read_fasta(f["seq"])]
        ia = initial_aligner.build_initial_msa(
            template, seqs, C.InitialAlignerConfig(band=args.align_band),
            dev)
        initial_aligner.write_outputs(ia, f["msa"], f["seqclass"])
        log_stage(workdir, "align", time.perf_counter() - t0,
                  {"rows": len(ia.rows),
                   "width": len(ia.rows[0]) if ia.rows else 0})
    if until < 3:
        return

    # ---- 4 realign
    if not skip("realign"):
        t0 = time.perf_counter()
        from .models import realigner
        msa = rio.read_msa(f["msa"])
        print(f"realign start: {msa.shape[0]} rows x {msa.shape[1]} "
              f"cols", flush=True)
        log: list = []
        rstats: dict = {}
        cfg = C.RealignerConfig(bandwidth=args.band,
                                block_rows=args.block_rows)
        # the host route is the JAX package's on its CPU backend: the
        # exact band on the native engine
        route = ({"mode": "exact", "kernel": "native"}
                 if dev.type == "cpu" else {})
        realigner.realign_batched(
            msa, cfg, out_path=f["msareal"], score_log=log,
            checkpoint_path=f["ckpt"], resume=True, stats=rstats,
            score_log_path=f["scorelog"], device=dev, **route)
        with open(f["done"], "w") as fh:
            json.dump({"rounds": rstats.get("rounds"),
                       "cells_per_s": rstats.get("cells_per_s")}, fh)
        log_stage(workdir, "realign", time.perf_counter() - t0, rstats)
    if until < 4:
        return

    # ---- 5 window
    msareal = rio.read_msa(f["msareal"])
    wins = windows(msareal)
    if until < 5:
        return

    # ---- 6 maxcorr (cached on disk like the reference)
    if not skip("maxcorr"):
        t0 = time.perf_counter()
        mc = maxcorrs(msareal, args, dev, f["maxcorrs"] + ".ckpt")
        rio.write_maxcorrs(f["maxcorrs"], mc)
        log_stage(workdir, "maxcorr", time.perf_counter() - t0,
                  {"nonzero": int((mc > 0).sum())})
    mc = rio.read_maxcorrs(f["maxcorrs"])
    if until < 6:
        return

    # ---- 7 resolve per window (each window resumable on its own files)
    results = {}
    for von, bis in wins:
        paths = subdivision_files(f["msareal"], von, bis)
        if all(os.path.exists(p) for p in paths.values()):
            results[(von, bis)] = {k: np.array(rio.read_ints(p))
                                   for k, p in paths.items()}
            continue
        t0 = time.perf_counter()
        out, cov = resolve(msareal, mc, von, bis, args, dev)
        for kind, u in out.items():
            rio.write_subdivision(paths[kind], u)
        results[(von, bis)] = out
        log_stage(workdir, f"resolve_{von}_{bis}",
                  time.perf_counter() - t0,
                  {"cov": cov,
                   "kmeans_clusters": int(out["Kmeans"].max()) + 1})
    if until < 7:
        return

    # ---- 8 assess
    t0 = time.perf_counter()
    from .models import assessment
    sd = assessment.SimDataset.load(workdir)
    gt = sd.ground_truth_resolution()
    summary = {}
    for (von, bis), out in sorted(results.items()):
        q = assessment.resolution_quality(gt, out["Kmeans"])
        summary[f"{von}_{bis}"] = {"tp": q.truepositives,
                                   "fp": q.falsepositives}
        print(f"[assess {von}-{bis}] tp={q.truepositives} "
              f"fp={q.falsepositives}", flush=True)
    left, right = sd.flanking()
    ordered = [results[k]["Kmeans"] for k in sorted(results)]
    _, multi = assessment.multi_step_resolution(left, ordered, right)
    summary["multi"] = {"tp": multi.truepositives,
                        "fp": multi.falsepositives,
                        "copies": int(len(np.unique(gt)))}
    print(f"[assess multi] tp={multi.truepositives} "
          f"fp={multi.falsepositives} of {len(np.unique(gt))}",
          flush=True)
    with open(f["assessment"], "w") as fh:
        json.dump(summary, fh, indent=1)
    log_stage(workdir, "assess", time.perf_counter() - t0, summary.get(
        "multi"))


if __name__ == "__main__":
    main()
