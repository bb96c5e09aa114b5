"""Spans and counters at the port's layer boundaries, on the host clock.

The recorder is off unless `enable()` turns it on, or RR_TRACE=1 is set
when this module is first imported (an operator's run: the totals are
then printed to standard error at exit). While it is off, `span`
returns one shared object that does nothing, and `count` and `record`
return at once: no clock is read and nothing is kept.

While it is on:

  * `span(name, attrs)` times a `with` block on `time.perf_counter_ns()`,
    the clock a device trace is aligned to by a marker kernel launched
    at a known host time, so spans and device operations share one
    timeline. Spans nest per thread; each knows its parent.
  * `record(name, t0_ns, t1_ns, attrs)` books an interval its caller
    has already timed (an accumulator's own clock reads, so that the
    interval is timed once) as a span closed at once. Spans that closed
    inside it under the same parent become its children.
  * `count(name, n)` adds to a counter.

`totals()` gives, a name, the spans' calls, seconds and self seconds
(less the parts their child spans cover), and the counters.
`timeline()` gives the last TIMELINE_MAX spans closed, to label what
the host was doing in a gap of a device trace.

Only the standard library is imported here.
"""
from __future__ import annotations

import atexit
import collections
import itertools
import os
import sys
import threading
import time

# spans kept for `timeline()`: the most recent ones
TIMELINE_MAX = 100_000

_on = False
_lock = threading.Lock()
_ids = itertools.count(1)
_totals: dict = {}              # name -> [calls, ns, self ns]
_counts: dict = {}
# (name, id, parent id, t0, t1, attrs) of the spans closed, in that order
_timeline: collections.deque = collections.deque(maxlen=TIMELINE_MAX)
_local = threading.local()      # .stack: this thread's open spans


class _Off:
    """What `span` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """An open span: name, attributes, id, parent id (0: none), start
    (ns) and the ns its children cover."""
    __slots__ = ("name", "attrs", "id", "parent", "t0", "child_ns")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.child_ns = 0

    def __enter__(self):
        st = _stack()
        self.parent = st[-1].id if st else 0
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        st = _stack()
        st.pop()
        _close(self.name, self.id, self.parent, self.t0, t1, self.child_ns,
               self.attrs, st)
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _close(name, sid, parent, t0, t1, child_ns, attrs, st) -> None:
    dur = t1 - t0
    with _lock:
        tot = _totals.get(name)
        if tot is None:
            tot = _totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child_ns
        _timeline.append((name, sid, parent, t0, t1, attrs))
    if st:
        st[-1].child_ns += dur


def span(name: str, attrs: dict | None = None):
    """A context manager timing its block as the span `name`."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def record(name: str, t0_ns: int, t1_ns: int,
           attrs: dict | None = None) -> None:
    """Book [t0_ns, t1_ns], timed by the caller on
    `time.perf_counter_ns()`, as a span under the open one; the spans
    that closed inside it under that one become its children."""
    if not _on:
        return
    st = _stack()
    parent = st[-1].id if st else 0
    sid = next(_ids)
    adopted = 0
    with _lock:
        # the spans closed since t0_ns are the timeline's last ones
        for i in range(len(_timeline) - 1, -1, -1):
            e = _timeline[i]
            if e[4] < t0_ns:
                break
            if e[2] == parent and e[3] >= t0_ns:
                _timeline[i] = e[:2] + (sid,) + e[3:]
                adopted += e[4] - e[3]
    if st:
        st[-1].child_ns -= adopted
    _close(name, sid, parent, t0_ns, t1_ns, adopted, attrs, st)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every total, counter and span closed so far."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _timeline.clear()


def totals() -> dict:
    """{"spans": {name: {"calls", "s", "self_s"}}, "counts": {name: n}}."""
    with _lock:
        return {"spans": {k: {"calls": v[0], "s": v[1] / 1e9,
                              "self_s": v[2] / 1e9}
                          for k, v in _totals.items()},
                "counts": dict(_counts)}


def timeline() -> list[tuple]:
    """The spans kept, in the order they closed: (name, id, parent id,
    t0 ns, t1 ns, attrs)."""
    with _lock:
        return list(_timeline)


def report(out=None) -> None:
    """The totals as a table, the longest spans first."""
    out = out or sys.stderr
    t = totals()
    print(f"{'span':32} {'calls':>9} {'s':>12} {'self s':>12}", file=out)
    for name, v in sorted(t["spans"].items(), key=lambda kv: -kv[1]["s"]):
        print(f"{name:32} {v['calls']:9d} {v['s']:12.4f} "
              f"{v['self_s']:12.4f}", file=out)
    for name, n in sorted(t["counts"].items()):
        print(f"{name:32} {n:9d}", file=out)


if os.environ.get("RR_TRACE") == "1":
    enable()
    atexit.register(report)
