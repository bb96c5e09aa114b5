"""The port's benchmark: one run of one cell.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. A run is one process: it makes the cell's
inputs from the seed, builds and warms up the cell's kernels and shapes
(set-up, `setup_s`), then runs the cell's units (cycles, jobs or scans)
back to back until the first one that ends after `--seconds`; the
window is the real time from its start to that end. After the window it
checks what the window produced against the plain reference, and prints
one JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device", "unit_s",
     "check_s", ["breakdown"], "checks"}

("unit_s": each unit's seconds in the window; "check_s": the check's
seconds; "attempted": the units run; "failed": the checks over their
limits.)

With --trace 0 the metrics are the cell's end-to-end metrics
(BENCHMARK.json says which; each but `setup_s` is the cell's rate, its
units' work over the window). With --trace 1 they are its per-layer
metrics, read from the port's counters and its kernels' CUDA events in
a window that runs no profiler, and from torch.profiler over one more
unit after the window (the device's busy and idle time, `breakdown`).
Every number compared is printed beside its limit, last on standard
error and under "checks". A run exits non-zero and prints no result when the card
is missing, or when JAX or the JAX package was loaded.

--control 1 (not part of the benchmark's command) puts the reference's
control in the program's place in the comparison: its result must come
out not correct (a realign cell adds the program's own numbers as
`program.<name>`).
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .importcheck import forbidden_modules  # noqa: E402
from .registry import Registry  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="bench_port.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _smi(query: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def _host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


class Context:
    """What a per-layer metric's reader reads: the window's length and
    units, the port's counters over the window, the recorded launches
    and their time inside each kernel, the card's SM count and clock,
    the profiled unit's reduction and the cell's traffic object."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(args, device, reg: Registry | None = None) -> dict:
    import torch
    from . import trace
    reg = reg or Registry()
    wl = reg.workload(args.workload)
    cfg = reg.config(wl["config"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    traffic = reg.traffic(wl["kind"]).prepare(cfg, wl, args.seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - _T0

    launches = trace.Launches(cuda) if args.trace else None
    if launches:
        launches.install()
    before = trace.counters()
    work = 0
    ends = []
    t_start = time.perf_counter()
    while True:
        work += traffic.unit()
        if cuda:
            torch.cuda.synchronize(dev)
        ends.append(time.perf_counter() - t_start)
        if ends[-1] >= args.seconds:
            break
    window_s = ends[-1]
    units = len(ends)
    counters = trace.delta(trace.counters(), before)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    breakdown = None
    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": int(wl["chips"]) if cuda else 0,
                  "memory_peak_bytes": int(peak),
                  "power_limit_w": _smi("power.limit") if cuda else "",
                  "host_cpu": _host_cpu(), "host_threads": os.cpu_count()}
    if not args.trace:
        for m in reg.metrics_of(args.workload, trace=False):
            # setup_s, and the cell's rate: its units' work over the window
            value = setup_s if m["name"] == "setup_s" else work / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        kernel_ms = launches.kernel_ms() if cuda else {}
        launches.uninstall()
        red = {"busy_s": None}
        if cuda:
            # one more unit, profiled, for the device's busy and idle time
            prof = trace.Profile()
            with prof.unit():
                traffic.unit()
            red = prof.reduce()
        if red.get("busy_s") is not None:
            device_rec["busy_s"] = red["busy_s"]
            device_rec["window_s"] = red["window_s"]
            breakdown = {"device_ops": red["device_ops"],
                         "idle_gaps": red["idle_gaps"]}
        sm_count = (torch.cuda.get_device_properties(dev).multi_processor_count
                    if cuda else 0)
        clk = _smi("clocks.max.sm") if cuda else ""
        ctx = Context(cell=args.workload, window_s=window_s, units=units,
                      work=work, counters=counters,
                      fills=launches.fills, block_steps=launches.block_steps,
                      kernel_ms=kernel_ms, sm_count=sm_count,
                      sm_hz=float(clk) * 1e6 if clk else 0.0,
                      profile=red, traffic=traffic)
        for m in reg.metrics_of(args.workload, trace=True):
            v = reg.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_check = time.perf_counter()
    checks = traffic.check(bool(args.control))
    failed = sum(1 for _, v, lim in checks if not v <= lim)
    result = {"correct": failed == 0, "attempted": units, "failed": failed,
              "metrics": metrics, "device": device_rec,
              "unit_s": [b - a for a, b in zip([0.0] + ends, ends)],
              "check_s": time.perf_counter() - t_check}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    reg = Registry()
    chips = int(reg.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(args, "cuda", reg)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"bench_port: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
