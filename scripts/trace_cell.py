"""One benchmark cell run with the port's span recorder on, and what its
spans say.

    python scripts/trace_cell.py --workload <cell> --seed <n>
        [--pairs 3] [--out FILE]

from the root of a checkout, on a CUDA device. It prepares the cell as
`bench_port.run` does (the same inputs from the seed, the same warm-up),
then runs `2 * pairs` units, one of each pair with the recorder off and
one with it on, in alternating order, and one more unit profiled
(`bench_port.trace.Profile`, the device's activity only) with the
recorder on. It prints, and writes to FILE as JSON:

  * the units' seconds with the recorder off and on (its cost);
  * the recorder's totals over the units run with it on, a unit;
  * the layer metrics derived from them (`derive`), and the whole-MSA
    passes on the host a unit (the counter `realign.host_msa_passes`);
  * the profiled unit's busy time and its longest idle gaps, each
    labelled by the innermost span the host was in: the program's,
    where one was open, else the benchmark's own; each gap's seconds
    under the root spans' children (`gap_parts`); and for each span
    name, its seconds and the device's busy seconds inside them
    (`busy_in_spans`: a span the device is busy through waits on it).

The traffic's check is not run: `bench_port.run` decides `correct`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# a cell's traffic kind -> the prefix of its metrics' names
PREFIX = {"realign_tail": "tail", "realign_resident": "resident",
          "maxcorr_scan": "maxcorr"}


def derive(tot: dict, prefix: str, units: int, unit_s: float) -> dict:
    """The layer metrics of `units` units (together `unit_s` seconds) from
    the recorder's totals over them (`trace.totals()`):

      <prefix>.call_host_s    realign.call less its realign.sweep spans,
                              a unit (the entry's host work: set-up,
                              EntAlGapper, the score, the respawn);
      resident.block_host_ms  the resident sweeps less their waits
                              (resident.wait, exact.wait), a block
                              (resident.block and resident.exact_block
                              spans);
      tail.serial_host_ms     serial.rows less serial.wait, a row;
      maxcorr.group_host_ms   maxcorr.group less its maxcorr.wait (its
                              self time), a group;
      <prefix>.call_cover     the root spans (realign.call or
                              maxcorr.call) over the units' seconds."""
    sp, cn = tot["spans"], tot["counts"]

    def s(name, key="s"):
        return sp.get(name, {}).get(key, 0.0)

    out = {}
    root = "maxcorr.call" if prefix == "maxcorr" else "realign.call"
    if root in sp and unit_s > 0:
        out[f"{prefix}.call_cover"] = s(root) / unit_s
    if "realign.call" in sp and units:
        out[f"{prefix}.call_host_s"] = (s("realign.call")
                                        - s("realign.sweep")) / units
    blocks = s("resident.block", "calls") + s("resident.exact_block", "calls")
    if blocks:
        out["resident.block_host_ms"] = 1e3 * (
            s("resident.sweep") - s("resident.wait") - s("exact.wait")
        ) / blocks
    if cn.get("serial.rows"):
        out["tail.serial_host_ms"] = 1e3 * (
            s("serial.rows") - s("serial.wait")) / cn["serial.rows"]
    if s("maxcorr.group", "calls"):
        out["maxcorr.group_host_ms"] = 1e3 * s(
            "maxcorr.group", "self_s") / s("maxcorr.group", "calls")
    return out


def per_unit(tot: dict, units: int) -> dict:
    """The totals divided by the units: seconds and self seconds, calls
    and counts."""
    return {"spans": {k: {f: v[f] / units for f in ("calls", "s", "self_s")}
                      for k, v in tot["spans"].items()},
            "counts": {k: n / units for k, n in tot["counts"].items()}}


def spans_between(timeline, t0_ns: int, t1_ns: int) -> list:
    """(name, t0, t1) of the recorder's spans that overlap [t0_ns, t1_ns],
    as `bench_port.trace.reduce_device` takes them."""
    return [(name, a, b) for name, _, _, a, b, _ in timeline
            if b >= t0_ns and a <= t1_ns]


def busy_intervals(dev, t_mark: int, t_end: int):
    """The device's busy intervals [(t0, t1)] on the host's clock (ns),
    merged, from its operations [(start, end, name)] in the trace's ns
    (sorted; the first with "fill" in its name the marker launched at
    host time t_mark), within the marker's end and t_end, as
    `bench_port.trace.reduce_device` reads them."""
    mark = next((d for d in dev if "fill" in d[2].lower()), dev[0])
    off = mark[0] - t_mark
    lo, hi = mark[1] - off, t_end
    out = []
    for a, b, _ in dev:
        if (a, b) == mark[:2]:
            continue
        a, b = max(a - off, lo), min(b - off, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out], lo, hi


def _busy_in(iv, starts, prefix, a: int, b: int) -> int:
    """ns of the busy intervals iv (their starts and prefix sums of their
    lengths) inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    j = bisect.bisect_left(starts, b)
    if i >= j:
        return 0
    ns = prefix[j] - prefix[i]
    ns -= max(0, min(iv[i][1], a) - iv[i][0])       # before a
    ns -= max(0, iv[j - 1][1] - max(b, iv[j - 1][0]))  # after b
    return max(ns, 0)


def busy_in_spans(iv, timeline) -> dict:
    """{span name: [host s, device busy s inside it]} over the spans of
    the timeline."""
    starts = [a for a, _ in iv]
    prefix = [0]
    for a, b in iv:
        prefix.append(prefix[-1] + b - a)
    out: dict = {}
    for name, _, _, a, b, _ in timeline:
        v = out.setdefault(name, [0.0, 0.0])
        v[0] += (b - a) / 1e9
        v[1] += _busy_in(iv, starts, prefix, a, b) / 1e9
    return out


def gap_parts(iv, lo: int, hi: int, timeline, top: int = 10) -> list:
    """The `top` longest idle gaps in [lo, hi] between the busy
    intervals iv: [seconds, {span: seconds of the gap under it}] for the
    children of the root spans (spans without a parent); "other" is the
    rest of the gap."""
    gaps, cur = [], lo
    for a, b in iv:
        if a > cur:
            gaps.append((a - cur, cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((hi - cur, cur, hi))
    gaps.sort(reverse=True)
    roots = {sid for _, sid, parent, *_ in timeline if not parent}
    out = []
    for g, a, b in gaps[:top]:
        parts: dict = {}
        for name, _, parent, t0, t1, _ in timeline:
            ov = min(b, t1) - max(a, t0)
            if ov > 0 and parent in roots:
                parts[name] = parts.get(name, 0.0) + ov / 1e9
        parts["other"] = g / 1e9 - sum(parts.values())
        out.append([g / 1e9, dict(sorted(parts.items(),
                                         key=lambda kv: -kv[1]))])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    from bench_port import trace as bench_trace
    from bench_port.registry import Registry
    from bench_port.run import _smi
    from repeatresolver_tpu_torch.utils import trace
    if not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    reg = Registry()
    wl = reg.workload(a.workload)
    dev = torch.device("cuda")
    traffic = reg.traffic(wl["kind"]).prepare(reg.config(wl["config"]), wl,
                                              a.seed, dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    def unit(on: bool) -> float:
        (trace.enable if on else trace.disable)()
        t0 = time.perf_counter()
        traffic.unit()
        torch.cuda.synchronize(dev)
        trace.disable()
        return time.perf_counter() - t0

    trace.reset()
    off, on = [], []
    for i in range(a.pairs):
        for flag in ((False, True) if i % 2 == 0 else (True, False)):
            (on if flag else off).append(unit(flag))
    tot = trace.totals()
    stats = dict(getattr(traffic, "stats", {}) or {})

    trace.reset()
    trace.enable()
    prof = bench_trace.Profile()
    with prof.unit():
        traffic.unit()
    trace.disable()
    timeline = trace.timeline()
    bench_trace.SPANS.extend(spans_between(timeline, prof.t_mark,
                                           prof.t_end))
    red = prof.reduce()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops = sorted(
        (bench_trace._ns(e, "start"),
         bench_trace._ns(e, "start") + bench_trace._ns(e, "duration"),
         e.name()) for e in prof.prof.profiler.kineto_results.events()
        if e.device_type() == cuda)
    iv, lo, hi = busy_intervals(dev_ops, prof.t_mark, prof.t_end)

    prefix = PREFIX[wl["kind"]]
    res = {"cell": a.workload, "seed": a.seed,
           "device": torch.cuda.get_device_name(dev),
           "power_limit_w": _smi("power.limit"), "setup_s": setup_s,
           "unit_s_off": off, "unit_s_on": on,
           "recorder_cost": statistics.median(on) / statistics.median(off)
           - 1,
           "derived": derive(tot, prefix, len(on), sum(on)),
           "host_msa_passes": tot["counts"].get("realign.host_msa_passes",
                                                0) / len(on),
           "per_unit": per_unit(tot, len(on)),
           "last_stats": stats, "profile": red,
           "gap_parts": gap_parts(iv, lo, hi, timeline),
           "busy_in_spans": busy_in_spans(iv, timeline)}
    print(json.dumps({k: res[k] for k in (
        "cell", "seed", "device", "power_limit_w", "setup_s", "unit_s_off",
        "unit_s_on", "recorder_cost", "derived", "host_msa_passes")}))
    print(json.dumps(red.get("idle_gaps")))
    print(json.dumps(res["gap_parts"][:4]))
    print(json.dumps({k: [round(h, 4), round(b, 4)] for k, (h, b) in
                      res["busy_in_spans"].items()}))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
