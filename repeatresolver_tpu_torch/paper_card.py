"""The paper-default run, stage by stage, measured, with its checks.

    python -m repeatresolver_tpu_torch.paper_card run --workdir DIR
        --out DIR [--deadline-s S] [--realign-limit-s S]
        [-- paper_run flags]

`run` drives repeatresolver_tpu_torch.paper_run one stage at a time,
each in a process of its own (`--until STAGE`: the driver skips the
stages whose files exist), and appends one JSON line a step to
OUT/report.jsonl: the step's seconds, peak device memory (allocated and
reserved), peak host RSS, each kernel's launches and seconds inside it
(CUDA events around every launch), the plain edit-DP loop's runs, and
for realign the resident sweeps, the host anneal tail by block size,
the best-MSA writes and the waits for them, and the scorelog's line
count over time. Between the stages it runs three checks on the run's
own files:

  trajectory  after align: 2 rounds at the run's band and block of the
              resident engine on the card against the host native exact
              engine, both with RR_FLUSH_CAP high (one flush a sweep),
              line for line; the resident run writes its best MSA every
              improving round (RR_BEST_WRITE_S=0, into WORKDIR/trajectory,
              removed after), so its write seconds stand beside the
              sweeps';
  maxcorr     after maxcorr: the stage's MaxCorrs against the host fast
              scan (compute_maxcorrs(fast=True)) on the same MSAreal:
              identical significance decisions, both times;
  resolve     after resolve: the first window through the host route
              (device "cpu") against the stage's three subdivision
              files, byte for byte, given the same MaxCorrs.

A step that would start past the deadline is left out, and a step still
running at it is stopped (SIGTERM: a stopped stage still reports what it
measured, after the best-MSA write in flight completes). With
--realign-limit-s, realign is stopped so, and the MaxCorrs scan and the
first window's resolve then run through the stages' own functions on
the best MSA realign had written, beside their checks, into probe_*
files (the driver's files stay unwritten; none, if realign had written
no best MSA yet). Run again with the same --workdir and --out, it goes
on where the files on disk say. The files' names and skip rules, the
windows, the MaxCorrs scan and a window's resolve are paper_run's own
functions.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from . import paper_run

# the steps in order; a tuple's steps run side by side, its checks
# waiting for the stage's records (the host scan and the host resolve
# are CPU work beside the card's)
PLAN = [("simulate",), ("cut",), ("align",), ("check:trajectory",),
        ("realign",), ("maxcorr", "check:maxcorr"),
        ("resolve", "check:resolve"), ("assess",)]
# after a realign stopped at --realign-limit-s: the MaxCorrs scan and
# the first window's resolve by the stages' own functions on the best
# MSA written, into probe_* files (the driver's files stay unwritten)
PROBE_PLAN = [("probe:maxcorr", "check:maxcorr"),
              ("probe:resolve", "check:resolve")]
STEPS = [s for group in PLAN + PROBE_PLAN for s in group]
# seconds a step has between SIGTERM and SIGKILL: a best-MSA write in
# flight (tens of seconds at the paper's size) completes
STOP_GRACE_S = 240.0
PROBE = "probe_"
PROG = "repeatresolver_tpu_torch.paper_card"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("staircase_fill", "walk_backtrack", "editdp_fill",
           "editdp_walk")


def _driver(workdir, driver_args, until):
    return (["--workdir", workdir] + list(driver_args)
            + ["--until", until])


def _files(workdir, driver_args):
    """The driver's arguments and files (paper_run.files)."""
    args = paper_run.build_parser().parse_args(_driver(
        workdir, driver_args, "assess"))
    return args, paper_run.files(workdir,
                                 paper_run.sim_config(args).dataset_name)


def _probe(path):
    """A probe step's file beside the driver's."""
    return os.path.join(os.path.dirname(path),
                        PROBE + os.path.basename(path))


# ------------------------------------------------------ one step, measured


def _counters():
    from .models import maxcorr, realigner
    from .models.realigner_device import DeviceResidentRealigner as Dev
    from .ops import cuda_backtrack as cb
    from .ops import cuda_editdp as ce
    from .ops import cuda_realign as cr
    from .ops import devmm, editdp
    launch = dict(zip(KERNELS, (cr.staircase_fill, cb.backtrack_moves,
                                ce.editdp_fill, ce.editdp_walk)))
    return launch, dict(
        plain=(editdp.forward_plain, editdp.walk_plain),
        maxcorr=maxcorr.compute_maxcorrs_device, devmm=devmm.matmul_t,
        rb=realigner.realign_batched, host=realigner.BatchedRealigner,
        dev=Dev)


class Stopped(Exception):
    """Raised in a step's main thread by SIGTERM: its time limit passed."""


def _stop(signum, frame):
    raise Stopped


def _measured(fn, dev_type):
    """Run fn() with every counter at 0 and the kernels' launches timed;
    returns (fn's value, the record)."""
    import torch
    from .ops import _build
    launch, c = _counters()
    for f in launch.values():
        f.launches = 0
    for f in c["plain"]:
        f.calls = 0
    c["maxcorr"].calls = 0
    c["devmm"].device_calls = 0
    c["rb"].write_s = []
    c["rb"].write_wait_s = 0.0
    c["host"].host_sweep_s_by_bs = {}
    c["dev"].resident_sweep_s = 0.0
    c["dev"].exact_blocks_run = c["dev"].exact_blocks_run_torch = 0
    cuda = dev_type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        _build.kernel_events = {}
    t0 = time.perf_counter()
    value, stopped = None, False
    try:
        value = fn()
    except Stopped:
        stopped = True
    finally:
        if cuda:
            torch.cuda.synchronize()
        events, _build.kernel_events = _build.kernel_events, None
    rec = {"s": time.perf_counter() - t0, "stopped": stopped,
           "kernels": {k: {"launches": f.launches,
                           "s": sum(a.elapsed_time(b) for a, b in
                                    (events or {}).get(k, [])) / 1e3}
                       for k, f in launch.items()},
           "plain_loop_runs": [f.calls for f in c["plain"]],
           "maxcorr_device_calls": c["maxcorr"].calls,
           "devmm_device_calls": c["devmm"].device_calls,
           "resident_sweep_s": c["dev"].resident_sweep_s,
           "host_sweep_s_by_bs": {str(k): v for k, v in
                                  c["host"].host_sweep_s_by_bs.items()},
           "exact_blocks": [c["dev"].exact_blocks_run,
                            c["dev"].exact_blocks_run_torch],
           "best_write_s": list(c["rb"].write_s),
           "best_write_wait_s": c["rb"].write_wait_s}
    if cuda:
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        rec["peak_device_reserved"] = torch.cuda.max_memory_reserved()
    return value, rec


def _finish(rec, report):
    rec["peak_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec["children_peak_rss_kb"] = resource.getrusage(
        resource.RUSAGE_CHILDREN).ru_maxrss
    with open(report, "a") as f:
        f.write(json.dumps(rec) + "\n")


def _watch_lines(path, trace, stop):
    """(seconds, line count) of `path` whenever the count changes."""
    t0, n = time.perf_counter(), -1
    while not stop.wait(2.0):
        try:
            with open(path, "rb") as f:
                m = f.read().count(b"\n")
        except OSError:
            continue
        if m != n:
            n = m
            trace.append((round(time.perf_counter() - t0, 1), m))


def step_stage(a, driver_args):
    args, f = _files(a.workdir, driver_args)
    trace, stop = [], threading.Event()
    watch = threading.Thread(target=_watch_lines, daemon=True, args=(
        f["scorelog"], trace, stop))
    if a.step == "realign":
        watch.start()
    signal.signal(signal.SIGTERM, _stop)
    try:
        _, rec = _measured(lambda: paper_run.main(
            _driver(a.workdir, driver_args, a.step)), args.device)
    finally:
        stop.set()
    rec.update(step=a.step, scorelog_lines=trace)
    if rec["stopped"]:
        # the best-MSA write in flight completes: the MSAreal on disk is
        # then the checkpoint's best
        for t in threading.enumerate():
            if "_write_best" in t.name:
                t.join()
        if os.path.exists(f["scorelog"]):
            with open(f["scorelog"]) as fh:
                rec["scorelog"] = fh.read().splitlines()
        if os.path.exists(f["ckpt"]):
            from .utils.checkpoint import RealignCheckpoint
            c = RealignCheckpoint.load(f["ckpt"])
            rec["checkpoint"] = {"round": c.round, "block_rows":
                                 c.block_rows, "shape": list(c.msa.shape)}
    _finish(rec, a.report)


def _wait_for(f, report, stage):
    """Block until a stage's files are complete: the driver's record in
    stage_times.json (its files) or a probe's line in the report
    (_probe files). Returns the function that names them."""
    sources = ((f["stage_times"], lambda p: p), (report, _probe))
    while True:
        for path, name in sources:
            if os.path.exists(path):
                with open(path) as fh:
                    if any(json.loads(ln).get("stage") == stage
                           for ln in fh):
                        return name
        time.sleep(2.0)


def step_check(a, driver_args):
    import torch
    from . import config as C
    from .models import maxcorr, realigner
    from .utils import io as rio
    args, f = _files(a.workdir, driver_args)
    dev = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    rec = {"step": a.step}
    if a.step == "check:trajectory":
        msa = rio.read_msa(f["msa"])
        os.environ["RR_FLUSH_CAP"] = str(1 << 40)
        os.environ["RR_BEST_WRITE_S"] = "0"
        cfg = C.RealignerConfig(bandwidth=args.band,
                                block_rows=args.block_rows, max_rounds=2)
        tmp = os.path.join(a.workdir, "trajectory")   # GB-sized files
        os.makedirs(tmp, exist_ok=True)
        log_d: list = []
        try:
            _, rec["resident"] = _measured(
                lambda: realigner.realign_batched(
                    msa.copy(), cfg, out_path=os.path.join(tmp, "MSAreal"),
                    checkpoint_path=os.path.join(tmp, "ckpt"),
                    score_log=log_d, anneal=False, device=dev), dev.type)
        finally:
            shutil.rmtree(tmp)
        log_h: list = []
        _, rec["host_native"] = _measured(lambda: realigner.realign_batched(
            msa.copy(), cfg, score_log=log_h, anneal=False, mode="exact",
            kernel="native", device="cpu"), "cpu")
        rec.update(shape=list(msa.shape), resident_log=log_d,
                   host_log=log_h, equal=log_d == log_h)
    elif a.step == "probe:maxcorr":
        msareal = rio.read_msa(f["msareal"])
        mc, rec["device"] = _measured(
            lambda: paper_run.maxcorrs(msareal, args, dev), dev.type)
        rio.write_maxcorrs(_probe(f["maxcorrs"]), mc)
        rec.update(stage="maxcorr", shape=list(msareal.shape),
                   nonzero=int((mc > 0).sum()))
    elif a.step == "probe:resolve":
        msareal = rio.read_msa(f["msareal"])
        mc = rio.read_maxcorrs(_probe(f["maxcorrs"]))
        von, bis = paper_run.windows(msareal)[0]
        (out, cov), rec["device"] = _measured(lambda: paper_run.resolve(
            msareal, mc, von, bis, args, dev), dev.type)
        paths = paper_run.subdivision_files(f["msareal"], von, bis)
        for kind, u in out.items():
            rio.write_subdivision(_probe(paths[kind]), u)
        rec.update(stage=f"resolve_{von}_{bis}", window=[von, bis],
                   cov=cov, kmeans_clusters=int(out["Kmeans"].max()) + 1)
    elif a.step == "check:maxcorr":
        # the host scan beside the stage, then the stage's file
        msareal = rio.read_msa(f["msareal"])
        mcfg = C.MaxCorrConfig()
        threads = max(1, (os.cpu_count() or 2) - 1)
        t0 = time.perf_counter()
        mc_h = maxcorr.compute_maxcorrs(msareal, mcfg, fast=True,
                                        threads=threads)
        rec.update(host_s=time.perf_counter() - t0, threads=threads)
        name = _wait_for(f, a.report, "maxcorr")
        mc = rio.read_maxcorrs(name(f["maxcorrs"]))
        cutoff = mcfg.resolved_cutoff(msareal.shape[1])
        sig = mc_h > cutoff
        dz = np.abs(mc - mc_h)
        rec.update(cutoff=cutoff, significant=int(sig.sum()),
                   values=len(mc_h), files=name("*"),
                   nonzero=[int((mc > 0).sum()), int((mc_h > 0).sum())],
                   decisions_differ=int(((mc > cutoff) != sig).sum()),
                   max_dz_significant=float(dz[sig].max())
                   if sig.any() else 0.0, max_dz=float(dz.max()))
        rec["equal"] = rec["decisions_differ"] == 0
    else:
        # the first window on the host beside the stage, then the
        # stage's files of that window
        msareal = rio.read_msa(f["msareal"])
        name = _wait_for(f, a.report, "maxcorr")
        mc = rio.read_maxcorrs(name(f["maxcorrs"]))
        von, bis = paper_run.windows(msareal)[0]
        t0 = time.perf_counter()
        out, cov = paper_run.resolve(msareal, mc, von, bis, args, "cpu")
        rec.update(window=[von, bis], cov=cov, files=name("*"),
                   host_s=time.perf_counter() - t0, differ=[])
        name = _wait_for(f, a.report, f"resolve_{von}_{bis}")
        paths = paper_run.subdivision_files(f["msareal"], von, bis)
        for kind, u in out.items():
            tmp = os.path.join(a.out, "host_" + os.path.basename(
                paths[kind]))
            rio.write_subdivision(tmp, u)
            with open(tmp, "rb") as f1, open(name(paths[kind]), "rb") as f2:
                if f1.read() != f2.read():
                    rec["differ"].append(os.path.basename(paths[kind]))
            os.unlink(tmp)
        rec["equal"] = not rec["differ"]
    _finish(rec, a.report)


# ------------------------------------------------------------ the driver


def _step_done(step, f, report):
    """A stage is done when the driver would skip it (paper_run.SKIP_IF;
    resolve skips its finished windows itself), assess when its file
    exists; a check when the report holds its line."""
    if step.startswith(("check:", "probe:")):
        if not os.path.exists(report):
            return False
        with open(report) as fh:
            return any(json.loads(ln).get("step") == step for ln in fh)
    if step == "assess":
        return os.path.exists(f["assessment"])
    return step in paper_run.SKIP_IF and os.path.exists(
        f[paper_run.SKIP_IF[step]])


def _popen(cmd, log):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env)


def _halt(p):
    """SIGTERM (a stage keeps its record), then SIGKILL."""
    if p.poll() is None:
        p.terminate()
        try:
            p.wait(timeout=STOP_GRACE_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _run_group(steps, a, report, driver_args, deadline):
    """The steps side by side, each a process of its own; realign also
    stops at --realign-limit-s. Returns None, or why the run stops: the
    deadline, a stopped realign, or a failed stage (a failed check is
    reported and the run goes on)."""
    procs = []
    try:
        for step in steps:
            log = open(os.path.join(a.out, "logs",
                                    step.replace(":", "_") + ".log"), "a")
            procs.append((step, log, _popen(
                [sys.executable, "-m", PROG, "step", "--step", step,
                 "--workdir", a.workdir, "--out", a.out, "--report",
                 report, "--"] + driver_args, log)))
        for step, _, p in procs:
            until = deadline
            if step == "realign" and a.realign_limit_s:
                until = min(until, time.time() + a.realign_limit_s)
            try:
                rc = p.wait(timeout=max(1.0, until - time.time()))
            except subprocess.TimeoutExpired:
                _halt(p)
                return ("realign limit" if until < deadline
                        else f"deadline in {step}")
            if rc != 0:
                if not step.startswith("check:"):
                    return f"{step} failed ({rc})"
                print(f"{step} failed ({rc})", flush=True)
        return None
    finally:
        for _, log, p in procs:
            _halt(p)
            log.close()


def run(a, driver_args):
    deadline = time.time() + a.deadline_s
    os.makedirs(a.out, exist_ok=True)
    os.makedirs(os.path.join(a.out, "logs"), exist_ok=True)
    report = os.path.join(a.out, "report.jsonl")
    _, f = _files(a.workdir, driver_args)
    status, plan = "done", list(PLAN)
    while plan:
        group = plan.pop(0)
        steps = [s for s in group
                 if not _step_done(s, f, report)]
        if not steps:
            continue
        if time.time() >= deadline:
            status = f"deadline before {steps[0]}"
            break
        print(f"[{time.strftime('%H:%M:%S')}] {' + '.join(steps)}",
              flush=True)
        why = _run_group(steps, a, report, driver_args, deadline)
        if why == "realign limit":
            # the later stages' device routes and checks, measured on
            # the best MSA realign had written
            print("realign stopped at its limit", flush=True)
            if not os.path.exists(f["msareal"]):
                status = "realign limit before its first best MSA"
                break
            status, plan = why, list(PROBE_PLAN)
        elif why:
            status = why
            break
    print(f"status: {status}", flush=True)
    if os.path.exists(f["stage_times"]):
        shutil.copy(f["stage_times"], os.path.join(a.out,
                                                   "stage_times.json"))
    return 0 if status == "done" \
        or status.startswith(("realign limit", "deadline")) else 1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    argv, driver_args = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(
        prog=f"python -m {PROG}",
        description=__doc__.split("\n\n")[0],
        epilog="paper_run's flags follow a lone --")
    ap.add_argument("command", choices=["run", "step"])
    ap.add_argument("--step", choices=STEPS)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--report")
    ap.add_argument("--deadline-s", type=float, default=3300.0)
    ap.add_argument("--realign-limit-s", type=float, default=0.0,
                    help="stop realign after this long and measure the "
                    "later stages on its best MSA so far (0: no limit)")
    a = ap.parse_args(argv)
    if a.command == "run":
        return run(a, driver_args)
    if a.step.startswith(("check:", "probe:")):
        step_check(a, driver_args)
    else:
        step_stage(a, driver_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
