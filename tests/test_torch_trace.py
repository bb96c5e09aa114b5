"""The port's span recorder (repeatresolver_tpu_torch/utils/trace.py) and
its spans at the layer boundaries, on the CPU.

  * off (the default): no record, one shared object from `span`, and no
    clock read from `span`, `count` or `record`;
  * on: nesting, parent ids, self time, totals and counters; `record`
    adopting the spans that closed inside its interval;
  * the span tree of `realign_batched` on the resident engine (its plain
    torch versions) and on the tail's engine (blocks 16, 4 and 1, F and
    G's plain versions): `realign.call` holds `realign.sweep`, which
    holds the engine's spans, and the call's children cover at least
    98% of it; the split clocks the recorder reuses agree with its
    spans;
  * a MaxCorrs device scan's `maxcorr.group` spans, one a host read of
    the alive seeds;
  * SplitClock's laps as `resolve.<part>` spans, a kernel build inside a
    lap as its child, and the build's span and counter;
  * paper_card's record of a step: the recorder's totals, the recorder
    off after;
  * `bench_port.trace.reduce_device` labelling an idle gap by the
    innermost program span; `scripts/trace_cell.py`'s split of a gap by
    the spans under the root, the device's busy time inside each span,
    and its layer metrics from synthetic totals (none without the
    recorder's spans).
"""
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from repeatresolver_tpu_torch.config import MaxCorrConfig, RealignerConfig
from repeatresolver_tpu_torch.models import maxcorr as pmc
from repeatresolver_tpu_torch.models import realigner as prt
from repeatresolver_tpu_torch.models import realigner_device as prd
from repeatresolver_tpu_torch.models import resolver as prs
from repeatresolver_tpu_torch.ops import _build
from repeatresolver_tpu_torch.utils import trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def recorder():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def _trace_cell():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", os.path.join(ROOT, "scripts", "trace_cell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_msa(seed, rows=16, tlen=300, d=0.06):
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, tlen)
    msa = np.full((rows, tlen), 5, np.int8)
    for k in range(rows):
        row = template.copy()
        muts = rng.random(tlen) < d
        row[muts] = rng.integers(0, 4, int(muts.sum()))
        row[rng.random(tlen) < 0.08] = 4
        lo = rng.integers(0, tlen // 8)
        hi = tlen - rng.integers(0, tlen // 8)
        msa[k, lo:hi] = row[lo:hi]
    return msa


def _tree(timeline):
    """{span id: (name, parent id, t0, t1)}"""
    return {i: (n, p, a, b) for n, i, p, a, b, _ in timeline}


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while the recorder is off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert not trace.enabled()
    a = trace.span("x")
    b = trace.span("y", {"k": 1})
    assert a is b
    with a:
        with trace.span("z"):
            trace.count("n", 3)
            trace.record("r", 1, 2)
    monkeypatch.undo()
    assert trace.totals() == {"spans": {}, "counts": {}}
    assert trace.timeline() == []


def test_nesting_self_time_totals_and_counters():
    trace.enable()
    with trace.span("outer", {"engine": "e"}):
        time.sleep(0.01)
        for _ in range(2):
            with trace.span("inner"):
                time.sleep(0.005)
                trace.count("inner.n")
        trace.count("inner.n", 5)
    trace.disable()
    with trace.span("after"):
        pass
    t = trace.totals()
    assert set(t["spans"]) == {"outer", "inner"}
    assert t["counts"] == {"inner.n": 7}
    outer, inner = t["spans"]["outer"], t["spans"]["inner"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert inner["self_s"] == inner["s"] >= 0.01
    assert outer["self_s"] == pytest.approx(outer["s"] - inner["s"])
    assert outer["self_s"] >= 0.01
    tl = trace.timeline()
    assert [x[0] for x in tl] == ["inner", "inner", "outer"]
    tree = _tree(tl)
    oid = next(i for i, v in tree.items() if v[0] == "outer")
    assert tree[oid][1] == 0 and tl[-1][5] == {"engine": "e"}
    for i, (name, parent, a, b) in tree.items():
        if name == "inner":
            assert parent == oid
            assert tree[oid][2] <= a <= b <= tree[oid][3]


def test_record_adopts_the_spans_closed_inside_it():
    trace.enable()
    with trace.span("call"):
        with trace.span("before"):
            pass
        t0 = time.perf_counter_ns()
        with trace.span("wait"):
            time.sleep(0.004)
        with trace.span("wait"):
            time.sleep(0.004)
        t1 = time.perf_counter_ns()
        trace.record("rows", t0, t1)
    tree = _tree(trace.timeline())
    ids = {v[0]: i for i, v in tree.items()}
    assert tree[ids["rows"]][1] == ids["call"]
    assert tree[ids["before"]][1] == ids["call"]
    assert [v[1] for v in tree.values() if v[0] == "wait"] == [ids["rows"]] * 2
    t = trace.totals()["spans"]
    assert t["rows"]["s"] == pytest.approx((t1 - t0) / 1e9)
    assert t["rows"]["self_s"] == pytest.approx(t["rows"]["s"]
                                                - t["wait"]["s"])
    assert t["call"]["self_s"] == pytest.approx(
        t["call"]["s"] - t["before"]["s"] - t["rows"]["s"])


def _children_cover(timeline, root="realign.call"):
    """Each root span's share covered by its direct children."""
    tree = _tree(timeline)
    out = []
    for i, (name, _, a, b) in tree.items():
        if name == root:
            kids = sum(y - x for n, p, x, y in tree.values() if p == i)
            out.append(kids / (b - a))
    return out


def _ancestors(tree, i):
    names = []
    while i:
        names.append(tree[i][0])
        i = tree[i][1]
    return names[1:]


def test_resident_span_tree(monkeypatch):
    cls = prd.DeviceResidentRealigner
    monkeypatch.setattr(cls, "resident_sweep_s", 0.0)
    monkeypatch.setattr(cls, "sweep_log", [])
    trace.enable()
    msa = make_msa(3, rows=40, tlen=300)
    log = []
    prt.realign_batched(msa, RealignerConfig(bandwidth=96, block_rows=8,
                                             max_rounds=3),
                        score_log=log, anneal=False, device="cpu")
    t = trace.totals()
    sp = t["spans"]
    assert sp["realign.call"]["calls"] == 1
    assert sp["realign.sweep"]["calls"] == len(cls.sweep_log) >= 1
    assert sp["resident.sweep"]["s"] == pytest.approx(cls.resident_sweep_s)
    assert sp["resident.block"]["calls"] == 5 * len(cls.sweep_log)
    assert "resident.exact_block" not in sp
    assert sp["realign.ent_al_gapper"]["calls"] == 2
    assert sp["realign.score"]["calls"] == len(log)
    tl = trace.timeline()
    tree = _tree(tl)
    for i, (name, *_rest) in tree.items():
        if name == "resident.upload":
            # the engine's set-up uploads the MSA
            assert _ancestors(tree, i) == ["realign.setup", "realign.call"]
        elif name.startswith("resident."):
            up = _ancestors(tree, i)
            assert up[-2:] == ["realign.sweep", "realign.call"], (name, up)
        if name == "resident.wait":
            assert "resident.sweep" in _ancestors(tree, i)
    assert min(_children_cover(tl)) >= 0.98


def test_tail_span_tree(monkeypatch):
    cls = prt.BatchedRealigner
    monkeypatch.setattr(cls, "card_tail_split",
                        dict.fromkeys(cls.CARD_SPLIT, 0))
    monkeypatch.setattr(cls, "card_serial_split",
                        dict.fromkeys(cls.SERIAL_SPLIT, 0))
    trace.enable()
    m = make_msa(17, rows=36, tlen=260)
    for bs in (16, 4, 1):
        m = prt.realign_batched(
            m.copy(), RealignerConfig(bandwidth=96, block_rows=bs,
                                      max_rounds=1),
            anneal=False, mode="exact", kernel="cuda", device="cpu")
    t = trace.totals()
    sp, cn = t["spans"], t["counts"]
    tail, serial = cls.card_tail_split, cls.card_serial_split
    assert sp["realign.call"]["calls"] == 3
    assert sp["tail.block"]["calls"] == tail["blocks"] > 0
    assert sp["tail.block"]["s"] == pytest.approx(tail["s"])
    assert sp["tail.flush"]["s"] == pytest.approx(tail["flush_s"])
    assert sp["tail.wait"]["calls"] >= tail["blocks"]
    assert cn["serial.rows"] == serial["rows"] == 36
    assert sp["serial.rows"]["s"] == pytest.approx(serial["rows_s"])
    assert sp["serial.upload"]["s"] == pytest.approx(serial["upload_s"])
    assert sp["serial.download"]["s"] == pytest.approx(serial["download_s"])
    assert sp["serial.wait"]["calls"] == serial["host_reads"]
    assert sp["serial.rows"]["self_s"] == pytest.approx(
        sp["serial.rows"]["s"] - sp["serial.wait"]["s"])
    tl = trace.timeline()
    tree = _tree(tl)
    for i, (name, *_rest) in tree.items():
        if name.startswith(("tail.", "serial.")):
            up = _ancestors(tree, i)
            assert up[-2:] == ["realign.sweep", "realign.call"], (name, up)
        if name == "serial.wait":
            assert _ancestors(tree, i)[0] == "serial.rows"
        if name == "tail.wait":
            assert _ancestors(tree, i)[0] == "tail.block"
    cover = _children_cover(tl)
    assert len(cover) == 3 and min(cover) >= 0.98


def test_maxcorr_groups_are_the_alive_reads():
    rng = np.random.default_rng(5)
    msa = np.where(rng.random((600, 700)) < 0.15, 5,
                   rng.integers(0, 5, (600, 700))).astype(np.int8)
    trace.enable()
    pmc.compute_maxcorrs_device(msa, MaxCorrConfig(mincov=20), tile=64,
                                device="cpu")
    last = pmc.compute_maxcorrs_device.last_stats
    sp = trace.totals()["spans"]
    assert sp["maxcorr.group"]["calls"] == last["groups_queued"] > 1
    # one more read: the seed tiles' flags, before the first group
    assert sp["maxcorr.wait"]["calls"] == last["host_reads"] \
        == sp["maxcorr.group"]["calls"] + 1
    assert sp["maxcorr.call"]["calls"] == sp["maxcorr.setup"]["calls"] \
        == sp["maxcorr.download"]["calls"] == 1
    assert sp["maxcorr.group"]["self_s"] < sp["maxcorr.group"]["s"]
    tree = _tree(trace.timeline())
    for i, (name, *_rest) in tree.items():
        if name != "maxcorr.call":
            assert "maxcorr.call" in _ancestors(tree, i)


class _Proc:
    returncode = 0

    def communicate(self):
        return "ok", None


def test_split_clock_laps_and_kernel_builds(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "build_info", {})
    trace.enable()
    clock = prs.SplitClock("cpu")
    clock.lap("extract")
    tmp, so = tmp_path / "lib.tmp", tmp_path / "lib.so"
    tmp.write_bytes(b"")
    _build._builds([("resolver_pairs", _Proc(), str(tmp), str(so),
                     time.perf_counter_ns())])
    clock.lap("relvars_pairs")
    assert so.exists() and "resolver_pairs" in _build.build_info
    t = trace.totals()
    sp = t["spans"]
    assert t["counts"] == {"kernel.builds": 1}
    assert set(sp) == {"resolve.extract", "resolve.relvars_pairs",
                       "kernel.build"}
    for part in ("extract", "relvars_pairs"):
        assert sp[f"resolve.{part}"]["s"] == pytest.approx(clock.s[part])
    tree = _tree(trace.timeline())
    ids = {v[0]: i for i, v in tree.items()}
    assert tree[ids["kernel.build"]][1] == ids["resolve.relvars_pairs"]
    assert sp["resolve.relvars_pairs"]["self_s"] == pytest.approx(
        sp["resolve.relvars_pairs"]["s"] - sp["kernel.build"]["s"])
    assert trace.timeline()[0][5] is None
    assert [x[5] for x in trace.timeline() if x[0] == "kernel.build"] \
        == [{"kernels": ["resolver_pairs"]}]


def test_paper_card_records_the_totals_a_step(monkeypatch):
    from repeatresolver_tpu_torch import paper_card
    host, dev = prt.BatchedRealigner, prd.DeviceResidentRealigner
    for obj, names in ((host, ("host_sweeps_by_route",
                               "host_sweep_s_by_route", "card_tail_split",
                               "card_serial_split")),
                       (dev, ("resident_sweep_s", "exact_blocks_run",
                              "exact_block_s", "sweep_log")),
                       (prt.realign_batched, ("write_s", "write_wait_s"))):
        for n in names:
            monkeypatch.setattr(obj, n, getattr(obj, n))
    msa = make_msa(4, rows=24, tlen=240)
    _, rec = paper_card._measured(lambda: prt.realign_batched(
        msa, RealignerConfig(bandwidth=96, block_rows=8, max_rounds=2),
        anneal=False, device="cpu"), "cpu")
    assert not trace.enabled()
    sp = rec["trace"]["spans"]
    assert sp["realign.call"]["calls"] == 1
    assert sp["resident.sweep"]["s"] == pytest.approx(rec["resident_sweep_s"])


def test_reduce_device_labels_gaps_by_the_innermost_program_span():
    from bench_port.trace import reduce_device
    tc = _trace_cell()
    trace.enable()
    t_mark = time.perf_counter_ns()
    with trace.span("realign.call"):
        with trace.span("realign.sweep"):
            with trace.span("resident.wait"):
                t = time.perf_counter()
                time.sleep(0.002)
                waited = time.perf_counter() - t
        # twice the wait's own length, however long a loaded host made it
        with trace.span("realign.ent_al_gapper"):
            time.sleep(max(0.004, 2 * waited))
    t_end = time.perf_counter_ns()
    spans = dict((n, (a, b)) for n, _, _, a, b, _ in trace.timeline())
    off = 10 ** 12              # the trace's clock less the host's
    w0, w1 = spans["resident.wait"]
    g0, g1 = spans["realign.ent_al_gapper"]
    dev = [(t_mark + off, t_mark + off + 1000, "fill_marker"),
           (t_mark + off + 2000, w0 + off + 100, "kernel_a"),
           (w1 + off - 100, g0 + off, "kernel_b"),
           (g1 + off, t_end + off, "kernel_c")]
    program = tc.spans_between(trace.timeline(), t_mark, t_end)
    bench = [("resident.job", t_mark, t_end)]
    red = reduce_device(dev, t_mark, t_end, bench + program)
    gaps = dict(red["idle_gaps"])
    assert max(gaps, key=gaps.get) == "realign.ent_al_gapper: before kernel_c"
    assert "resident.wait: before kernel_b" in gaps
    red = reduce_device(dev, t_mark, t_end, bench)
    assert all(k.startswith("resident.job:") for k, _ in red["idle_gaps"])
    # the gaps' parts under the root's children, and the device's busy
    # time inside each span
    iv, lo, hi = tc.busy_intervals(dev, t_mark, t_end)
    assert iv == [(t_mark + 2000, w0 + 100), (w1 - 100, g0), (g1, t_end)]
    assert (lo, hi) == (t_mark + 1000, t_end)
    parts = tc.gap_parts(iv, lo, hi, trace.timeline(), top=2)
    assert parts[0][0] == pytest.approx((g1 - g0) / 1e9)
    assert parts[0][1]["realign.ent_al_gapper"] == pytest.approx(
        parts[0][0])
    assert parts[1][0] == pytest.approx((w1 - w0 - 200) / 1e9)
    assert parts[1][1]["realign.sweep"] == pytest.approx(parts[1][0])
    assert parts[1][1]["other"] == pytest.approx(0.0, abs=1e-12)
    busy = tc.busy_in_spans(iv, trace.timeline())
    assert busy["resident.wait"] == pytest.approx([(w1 - w0) / 1e9, 2e-7])
    assert busy["realign.ent_al_gapper"][1] == 0.0


def test_layer_metrics_from_totals():
    tc = _trace_cell()

    def tot(spans, counts):
        """spans: {name: (s, self_s[, calls])}"""
        return {"spans": {k: {"calls": (v + (1,))[2], "s": v[0],
                              "self_s": v[1]} for k, v in spans.items()},
                "counts": counts}

    resident = tc.derive(tot({"realign.call": (20.0, 0.1),
                              "realign.sweep": (12.0, 0.0),
                              "resident.sweep": (11.0, 1.0),
                              "resident.wait": (4.0, 4.0),
                              "resident.block": (3.0, 3.0, 650),
                              "resident.exact_block": (1.0, 1.0, 50)},
                             {}), "resident", 2, 20.2)
    assert resident == pytest.approx({"resident.call_cover": 20.0 / 20.2,
                                      "resident.call_host_s": 4.0,
                                      "resident.block_host_ms": 10.0})
    tail = tc.derive(tot({"realign.call": (39.0, 0.0),
                          "realign.sweep": (33.0, 0.0),
                          "serial.rows": (18.0, 2.0),
                          "serial.wait": (16.0, 16.0)},
                         {"serial.rows": 2000}), "tail", 3, 39.3)
    assert tail["tail.call_host_s"] == pytest.approx(2.0)
    assert tail["tail.serial_host_ms"] == pytest.approx(1.0)
    mc = tc.derive(tot({"maxcorr.call": (7.0, 0.1),
                        "maxcorr.group": (6.0, 2.0, 4000)}, {}),
                   "maxcorr", 1, 7.2)
    assert mc == pytest.approx({"maxcorr.call_cover": 7.0 / 7.2,
                                "maxcorr.group_host_ms": 0.5})
    # a program without the recorder's spans gives no metric
    assert tc.derive({"spans": {}, "counts": {}}, "tail", 3, 39.3) == {}
