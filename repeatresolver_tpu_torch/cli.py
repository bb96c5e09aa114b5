"""Command-line interface of the port.

    python -m repeatresolver_tpu_torch.cli simulate -c 40 -n 100 -d 1 -l 30000 -t Tree
    python -m repeatresolver_tpu_torch.cli cut      <Template.fasta> <reads.fasta> [-p 60 -e 0.30] [--device cuda|cpu]
    python -m repeatresolver_tpu_torch.cli align    <Template.fasta> <Seq.fasta> [-e 0.30] [--device cuda|cpu]
    python -m repeatresolver_tpu_torch.cli realign  <MSA> [-o MSAreal -b 1000 -B 16] [--device cuda|cpu]
    python -m repeatresolver_tpu_torch.cli maxcorr  <MSAreal> [-c 30 -p 1]
    python -m repeatresolver_tpu_torch.cli window   <MSAreal> [-c 0.90 -p 6]
    python -m repeatresolver_tpu_torch.cli resolve  <MSAreal> -f von bis [-c 30] [--device cuda|cpu]
    python -m repeatresolver_tpu_torch.cli assess   <dataset_dir> <resolution_dir>
    python -m repeatresolver_tpu_torch.cli assess-transposon <KmeansSubdivisionOf_...>
    python -m repeatresolver_tpu_torch.cli pipeline [-c 40 -n 100 ...] -w workdir [--device cuda|cpu]

Flags, output files and printed lines are those of repeatresolver_tpu's
CLI. `--device` names where a stage's device route runs: "cuda" (the
default; raises when torch sees no GPU) or "cpu". cut and align on
"cuda" run the edit DP on the card, on "cpu" the native host kernels;
realign on "cpu" runs the kernels' plain torch versions; resolve sends
its exact products above the devmm gate to the device. maxcorr runs on
the host, as the JAX CLI's does; the pipeline routes it to the device
scan on "cuda" for large MSAs.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="repeatresolver_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate")
    s.add_argument("-c", type=int, default=40, help="coverage")
    s.add_argument("-n", type=int, default=100, help="copynumber")
    s.add_argument("-d", type=float, default=1.0, help="difference %")
    s.add_argument("-l", type=int, default=30000, help="repeat length")
    s.add_argument("-t", default="Tree",
                   choices=["Tree", "Distributed", "EquiDistant"])
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--outdir", default=".")

    s = sub.add_parser("cut")
    s.add_argument("template")
    s.add_argument("reads")
    s.add_argument("-p", type=int, default=60, help="parts")
    s.add_argument("-l", type=int, default=0, help="overlap")
    s.add_argument("-e", type=float, default=0.30)
    s.add_argument("-w", type=int, default=150)
    s.add_argument("-o", default=None)
    s.add_argument("-r", default=None)
    _device_arg(s, "where the edit DP runs (cpu: native host kernel)")

    s = sub.add_parser("align")
    s.add_argument("template")
    s.add_argument("seqs")
    s.add_argument("-e", type=float, default=0.30)
    s.add_argument("-o", default=None)
    s.add_argument("-s", default=None)
    _device_arg(s, "where the edit DP runs (cpu: native host kernel)")

    s = sub.add_parser("realign")
    s.add_argument("msa")
    s.add_argument("-o", default="MSAreal")
    s.add_argument("-b", type=int, default=1000)
    s.add_argument("-B", "--block-rows", type=int, default=16,
                   help="rows per Jacobi block (1 = exact reference "
                        "trajectory via the serial engine, slower)")
    _device_arg(s, "where the resident realign engine runs")

    s = sub.add_parser("maxcorr")
    s.add_argument("msa")
    s.add_argument("-c", type=int, default=30)
    s.add_argument("-p", type=int, default=1,
                   help="fork workers striped over seed tiles")

    s = sub.add_parser("window")
    s.add_argument("msa")
    s.add_argument("-c", type=float, default=0.90)
    s.add_argument("-p", type=int, default=6)

    s = sub.add_parser("resolve")
    s.add_argument("msa")
    s.add_argument("-f", nargs=2, type=int, required=True,
                   metavar=("VON", "BIS"))
    s.add_argument("-c", type=int, default=30)
    s.add_argument("-t", type=float, default=0.0)
    _device_arg(s, "where the exact products above the gate run")

    s = sub.add_parser("assess")
    s.add_argument("dataset_dir")
    s.add_argument("resolution_dir")

    s = sub.add_parser("assess-transposon")
    s.add_argument("kmeanspath",
                   help="KmeansSubdivisionOf_<von>_<bis>_<msa> path; "
                        "sibling files are derived like the reference "
                        "(TransposonAssessment.py:26-43)")
    s.add_argument("--cutoff", type=float, default=1.0)

    s = sub.add_parser("pipeline")
    s.add_argument("-c", type=int, default=40)
    s.add_argument("-n", type=int, default=100)
    s.add_argument("-d", type=float, default=1.0)
    s.add_argument("-l", type=int, default=30000)
    s.add_argument("-t", default="Tree")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("-w", "--workdir", default="run")
    s.add_argument("-b", type=int, default=1000, help="realign band")
    s.add_argument("-B", "--block-rows", type=int, default=16,
                   help="realign rows per Jacobi block (1 = exact "
                        "reference trajectory, slower)")
    _device_arg(s, "where the stages' device routes run")

    args = p.parse_args(argv)
    from .config import (InitialAlignerConfig, MaxCorrConfig,
                         PipelineConfig, ReadCutterConfig, RealignerConfig,
                         ResolverConfig, SimulatorConfig, WindowConfig)
    from .utils import io as rio

    if args.cmd == "simulate":
        from repeatresolver_tpu.models.simulator import simulate
        cfg = SimulatorConfig(coverage=args.c, copynumber=args.n,
                              difference=args.d / 100.0,
                              repeatlength=args.l, structure=args.t,
                              seed=args.seed)
        ds = simulate(cfg)
        paths = ds.write(args.outdir)
        print(f"dataset {ds.name}: {len(ds.reads)} reads")
        for k, v in paths.items():
            print(f"  {k}: {v}")

    elif args.cmd == "cut":
        from .models.read_cutter import cut_reads
        template = rio.read_template(args.template).astype(np.int16)
        reads = [r.astype(np.int16) for r in rio.read_fasta(args.reads)]
        cfg = ReadCutterConfig(parts=args.p, overlap=args.l,
                               error_cutoff=args.e, wiggleroom=args.w)
        res = cut_reads(template, reads, cfg, device=args.device)
        d = rio.derived_paths(args.template)
        out = args.o or d["seq_fasta"]
        rinfo = args.r or d["readseqinfo"]
        rio.write_fasta(out, res.pieces, line_width=None)
        rio.write_readseqinfo(rinfo, res.seqs_per_read)
        print(f"{len(res.pieces)} pieces -> {out}")

    elif args.cmd == "align":
        from .models.initial_aligner import build_initial_msa, \
            write_outputs
        template = rio.read_template(args.template).astype(np.int16)
        seqs = [s.astype(np.int16) for s in rio.read_fasta(args.seqs)]
        res = build_initial_msa(template, seqs,
                                InitialAlignerConfig(error_cutoff=args.e),
                                device=args.device)
        d = rio.derived_paths(args.template)
        out = args.o or d["msa"]
        scp = args.s or d["seqclass"]
        write_outputs(res, out, scp)
        print(f"{len(res.rows)} rows -> {out}")

    elif args.cmd == "realign":
        from .models.realigner import realign_batched
        msa = rio.read_msa(args.msa)
        log: list = []
        cfg = RealignerConfig(bandwidth=args.b,
                              block_rows=args.block_rows)
        realign_batched(msa, cfg, out_path=args.o, score_log=log,
                        device=args.device)
        for m, u in log:
            print(f"OverallScore: {m}{u:06d}")
        print(f"-> {args.o}")

    elif args.cmd == "maxcorr":
        from .models.maxcorr import run
        run(args.msa, MaxCorrConfig(mincov=args.c), threads=args.p)
        print(f"-> {rio.maxcorrs_path(args.msa)}")

    elif args.cmd == "window":
        from .models.window import window_boundaries
        msa = rio.read_msa(args.msa)
        bounds = window_boundaries(msa, WindowConfig(coverage=args.c,
                                                     parts=args.p))
        print(" ".join(str(b) for b in bounds))

    elif args.cmd == "resolve":
        from .models.resolver import run
        von, bis = args.f
        run(args.msa, von, bis, ResolverConfig(cov=args.c, cutoff=args.t),
            device=args.device)
        for kind in ("Dropoff", "RelDrop", "Kmeans"):
            print(f"-> {rio.subdivision_path(kind, von, bis, args.msa)}")

    elif args.cmd == "assess":
        from .models.assessment import assess_directory
        singles, multi = assess_directory(args.dataset_dir,
                                          args.resolution_dir)
        for q in singles:
            print(f"truepositives {q.truepositives}, falsepositives "
                  f"{q.falsepositives} bei cutoff 0.0.")
        print(f"MultiStep: tp={multi.truepositives} "
              f"fp={multi.falsepositives}")

    elif args.cmd == "assess-transposon":
        _assess_transposon(args.kmeanspath, args.cutoff)

    elif args.cmd == "pipeline":
        from .pipeline import run_pipeline
        cfg = PipelineConfig(
            simulator=SimulatorConfig(coverage=args.c, copynumber=args.n,
                                      difference=args.d / 100.0,
                                      repeatlength=args.l,
                                      structure=args.t, seed=args.seed),
            realigner=RealignerConfig(bandwidth=args.b,
                                      block_rows=args.block_rows))
        run_pipeline(cfg, args.workdir, device=args.device)

    return 0


def _device_arg(parser, what: str) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda", help=what)


def _assess_transposon(kmeanspath: str, cutoff: float) -> None:
    """The reference TransposonAssessment.py on one Kmeans subdivision
    file and its siblings (TransposonAssessment.py:26-43)."""
    from .models import assessment as am
    from .utils import io as rio
    base = os.path.basename(kmeanspath)
    d = os.path.dirname(kmeanspath) or "."
    parts = base.split("_")
    von, bis = int(parts[1]), int(parts[2])
    number = parts[4]
    suffix = base[len("KmeansSubdivisionOf"):]
    msa = rio.read_msa(os.path.join(d, f"MidTransposonMMA_{number}_real"))
    mc = rio.read_maxcorrs(os.path.join(
        d, f"MaxCorrsOf_MidTransposonMMA_{number}_real"))
    col_mc = mc.reshape(-1, 5).max(axis=1)
    gt = rio.read_ints(os.path.join(d, f"TransposonCopies_{number}"))
    sigs = am.signatures(msa, col_mc, cutoff, von, bis)
    _, summe = am.resolvability(gt, sigs)
    print("unique groups at >0..10 diffs:", summe.tolist())
    _, _, hc = am.half_resolvability(gt, sigs)
    print(f"{hc['biggerbigger']}/"
          f"{hc['biggerbigger'] + hc['biggersmaller']} bigger and "
          f"{hc['smallerbigger']}/"
          f"{hc['smallerbigger'] + hc['smallersmaller']} smaller 5 "
          f"have >5 in the second half.")
    for kind in ("Dropoff", "RelDrop", "Kmeans"):
        path = os.path.join(d, f"{kind}SubdivisionOf{suffix}")
        if os.path.exists(path):
            res = am.resolution_quality(gt, rio.read_ints(path),
                                        mask_unassigned=False)
            print(f"{kind}: truepositives {res.truepositives}, "
                  f"falsepositives {res.falsepositives}")
            print(f"{kind} conconf: {res.conconfpositives}")


if __name__ == "__main__":
    sys.exit(main())
