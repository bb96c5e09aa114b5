"""What a traced run (`--trace 1`) reads besides the clock.

  * `Launches`: stand-ins around the port's kernel wrappers that record
    each launch's shapes (for the roofline counts) and count the
    resident engine's block steps, with the wrappers' own CUDA events
    (`ops/_build.kernel_events`) for the time inside each kernel.
  * `counters`: the port's counters and split clocks, read before and
    after the window.
  * `Profile`: torch.profiler over one more unit after the window: the
    device's busy time (the union of its operations' intervals), the
    largest device operations, and the longest idle gaps with the span
    the host was in.

The counters and the kernels' events are read in a window that runs no
profiler, so that they time the program and not the profiler.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import time

# (name, start ns, end ns) of the last host spans
SPANS: list = []


class Launches:
    """Records launches of kernels A and F (whose calls carry the shapes
    of B's and G's launches too), the MaxCorrs scan's int8 products and
    the resident engine's block steps, while installed."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.fills = {"exact_fill": [], "staircase_fill": [],
                      "maxcorr_product": []}
        self.block_steps = 0
        self._saved = []

    def install(self):
        from repeatresolver_tpu_torch.models import maxcorr as mcm
        from repeatresolver_tpu_torch.models import realigner_device as rd
        from repeatresolver_tpu_torch.ops import _build
        from repeatresolver_tpu_torch.ops import cuda_exact as ce
        from repeatresolver_tpu_torch.ops import cuda_realign as cr
        fills = self.fills
        f0, a0, s0 = ce.exact_fill, cr.staircase_fill, rd.block_step

        @functools.wraps(f0)
        def exact_fill(counts, rows_old, seqs, ways, lengths, ncols, **kw):
            fills["exact_fill"].append(
                (rows_old.shape[0], seqs.shape[1], rows_old.shape[1],
                 kw["bandwidth"], lengths))
            return f0(counts, rows_old, seqs, ways, lengths, ncols, **kw)

        @functools.wraps(a0)
        def staircase_fill(counts, rows_old, seqs, ways, lengths, ncols,
                           **kw):
            fills["staircase_fill"].append(
                (rows_old.shape[0], seqs.shape[1], rows_old.shape[1],
                 kw["bandwidth"], kw["chunk"], kw.get("widen", 1), lengths))
            return a0(counts, rows_old, seqs, ways, lengths, ncols, **kw)

        @functools.wraps(s0)
        def block_step(*a, **kw):
            self.block_steps += 1
            return s0(*a, **kw)

        p0 = mcm.MaxCorrScan.product

        @functools.wraps(p0)
        def product(scan, i0, j0, m):
            lo, hi = scan.windows[i0 // scan.t]
            fills["maxcorr_product"].append((hi - lo, scan.t, m))
            return p0(scan, i0, j0, m)

        self._saved = [(ce, "exact_fill", f0), (cr, "staircase_fill", a0),
                       (rd, "block_step", s0),
                       (mcm.MaxCorrScan, "product", p0),
                       (_build, "kernel_events", _build.kernel_events)]
        ce.exact_fill, cr.staircase_fill = exact_fill, staircase_fill
        rd.block_step = block_step
        mcm.MaxCorrScan.product = product
        # CUDA events around the launches, on a card only
        _build.kernel_events = {} if self.cuda else None

    def kernel_ms(self) -> dict:
        """ms inside each kernel over the recorded launches (their CUDA
        events; read after a device sync)."""
        from repeatresolver_tpu_torch.ops import _build
        ev = _build.kernel_events or {}
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in ev.items()}

    def uninstall(self):
        for mod, name, orig in self._saved:
            # the wrappers count their launches on the function their
            # module names (functools.wraps copied the count over)
            if hasattr(orig, "launches"):
                orig.launches = getattr(mod, name).launches
            setattr(mod, name, orig)
        self._saved = []


def counters() -> dict:
    """A copy of the port's counters and split clocks."""
    from repeatresolver_tpu_torch.models.realigner import BatchedRealigner
    from repeatresolver_tpu_torch.models.realigner_device import \
        DeviceResidentRealigner as D
    return copy.deepcopy({
        "card_tail_split": BatchedRealigner.card_tail_split,
        "card_serial_split": BatchedRealigner.card_serial_split,
        "exact_blocks_run": D.exact_blocks_run,
        "exact_block_s": D.exact_block_s,
        "resident_sweep_s": D.resident_sweep_s,
        "resident_sweeps": len(D.sweep_log),
    })


def delta(after, before):
    """after - before, key by key, for nested dicts of numbers."""
    if isinstance(after, dict):
        return {k: delta(v, before.get(k, 0) if isinstance(before, dict)
                         else 0) for k, v in after.items()}
    return after - before


class Profile:
    """torch.profiler over one unit after the window, with the device's
    activity only (recording every host op more than doubled a unit's
    time), reduced to busy time, the largest device operations and the
    longest idle gaps, each labelled by the bench span the host was in
    (`span`) and the device operation that ended it. The spans are timed on the host's
    clock; a marker kernel launched after a sync at the unit's start maps
    that clock onto the trace's."""

    def __init__(self):
        self.prof = None
        self.t_mark = self.t_end = 0

    @contextlib.contextmanager
    def unit(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        mark = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            SPANS.clear()
            self.t_mark = time.perf_counter_ns()
            mark.fill_(1.0)
            yield
            torch.cuda.synchronize()
            self.t_end = time.perf_counter_ns()
        self.prof = p

    def reduce(self) -> dict:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev = sorted((_ns(e, "start"), _ns(e, "start") + _ns(e, "duration"),
                      e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == cuda)
        return reduce_device(dev, self.t_mark, self.t_end, list(SPANS))


def reduce_device(dev, t_mark: int, t_end: int, spans) -> dict:
    """dev: the device's operations [(start, end, name)] in the trace's ns,
    sorted, the first of them the marker launched at host time t_mark
    (ns); t_end: the host time of the unit's last sync; spans: [(name,
    t0, t1)] in host ns. Busy seconds (the union of the operations after
    the marker), the window's seconds, the ten largest operations by
    total time and the ten longest idle gaps."""
    if not dev:
        return {"busy_s": None}
    mark = next((d for d in dev if "fill" in d[2].lower()), dev[0])
    off = mark[0] - t_mark
    lo, hi = mark[1], t_end + off
    ops = [d for d in dev if d is not mark and d[1] > lo and d[0] < hi]
    busy = 0
    gaps = []
    cur0 = cur1 = lo
    for t0, t1, name in ops:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t0 > cur1:
            busy += cur1 - cur0
            gaps.append((t0 - cur1, cur1, t0, name))
            cur0 = t0
        cur1 = max(cur1, t1)
    busy += cur1 - cur0
    if hi > cur1:
        gaps.append((hi - cur1, cur1, hi, "the unit's end"))
    by_name: dict = {}
    for t0, t1, name in ops:
        by_name[name] = by_name.get(name, 0) + (t1 - t0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(reverse=True)
    idle = []
    for g, a, b, nxt in gaps[:10]:
        mid = (a + b) / 2 - off
        sp = min((x for x in spans if x[1] <= mid <= x[2]),
                 key=lambda x: x[2] - x[1], default=None)
        idle.append([f"{sp[0] if sp else 'unit'}: before {nxt[:120]}",
                     g / 1e9])
    return {"busy_s": busy / 1e9, "window_s": (t_end - t_mark) / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": idle}


def _ns(e, what: str) -> int:
    for attr, scale in ((f"{what}_ns", 1), (f"{what}_us", 1000)):
        f = getattr(e, attr, None)
        if f is not None:
            return int(f() * scale)
    raise AttributeError(f"profiler event has no {what} time")


@contextlib.contextmanager
def span(name: str):
    """A host span, timed on the host's clock, that labels the idle gaps
    of a profiled unit."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        SPANS.append((name, t0, time.perf_counter_ns()))
        del SPANS[:-1000]
